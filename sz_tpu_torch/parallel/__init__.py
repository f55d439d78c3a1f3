"""Multi-device and multi-process compression: the slab codec
(``slab.py``) over several devices, streams and processes."""
