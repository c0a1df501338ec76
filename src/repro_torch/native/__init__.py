"""Host code of the port written in C and bound with ctypes, built by the
host's C compiler into ``build/native/`` (``block_decode``: the LSM
store's chunk decoder), and ``build``: how the port builds and loads each
of its hand-written libraries, the CUDA kernels' too."""
