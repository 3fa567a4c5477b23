"""The port's C ABI: ``bridge.cpp``, the header it implements
(``multiviewnative_tpu.h``), the C host smoke (``abi_smoke.c``) and their
``g++`` builder (:mod:`._build`)."""
