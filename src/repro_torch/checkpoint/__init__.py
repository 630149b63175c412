"""Checkpoints: msgpack trees of numpy bytes with JSON meta (``checkpointer``)."""
