"""The native WaveRNN engine (a host CPU engine in C++, the vocoder's second
backend): the RTVCNAT1 weight converter (``convert``) and the ctypes
binding (``libwavernn``); the sources under ``src/`` are built by
``_build.build_wavernn_engine``."""
