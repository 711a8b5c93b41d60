"""The port's counterparts of ``anomod/parallel``: so far only the
single-device cores the sequence models call (``full_attention``,
``linear_recurrence``); the mesh planes come with their own slice."""
