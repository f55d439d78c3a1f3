"""Multi-device and multi-process compression: the slab codec
(``slab.py``) over several devices, streams and processes; and the
reference's sz_omp byte format on host threads (``ompsz.py``)."""
