"""Host runtime of the port: the native C++/OpenMP inspector
(`native.py`, built from `tpusparse_torch/csrc/inspector.cpp`)."""
