"""The port's host C++ sources and their ``g++`` build (``_build.py``)."""
