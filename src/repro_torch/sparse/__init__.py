"""Sparse inference runtime: the 2:4 compressed format, the mask bank and
compressed execution (port of ``repro.sparse``)."""
