"""Batched execution on one card (the port's copy of ``das4whales_tpu.parallel``)."""
