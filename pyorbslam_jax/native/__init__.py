"""Native (C++) host-side components.

The map core is built from ``mapcore.cpp`` with ``g++`` on first use (or
ahead of time with ``python -m pyorbslam_jax.native.build``); the built
library is not part of the source tree.
"""
