"""PyTorch port of ``repro`` for one NVIDIA H100 (Hopper, sm_90a).

The package mirrors ``src/repro``'s layout module for module, so each
port module has one obvious reference counterpart.  It imports ``torch``
only: nothing of JAX and nothing of the ``repro`` package.  Every entry
point takes an explicit ``device`` (default ``"cuda"``); asking for the
card on a machine without one raises instead of falling back to the CPU.
"""
