"""The host C++ runtime (loader.py over csrc/host/hehub_native.cpp)."""
