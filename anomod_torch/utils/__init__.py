"""Host utilities of the port (counterpart of ``anomod/utils``)."""
