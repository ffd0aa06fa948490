"""The port's host runtime: a C++ library built from ``runtime/csrc`` at
first use and bound through ctypes (``runtime/native.py``)."""
