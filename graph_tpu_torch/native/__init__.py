"""The port's host C++ (edge-list parser, host CSR builder), built by g++
at first use and bound with ctypes."""
