"""Corpus loading and host-to-device staging for the port."""
