"""Native (C++) host runtime of the port: the asynchronous chain writer.

Port of ``glabc_tpu/native``.  Formatting and disk IO of the chain history
run on a C++ thread, so handing a segment over never waits on the disk.
The library builds with ``g++`` at first use into
``glabc_tpu_torch/_build/``; without a toolchain the writers fall back to
Python.  This is host file IO only: it touches no kernel and no device.
"""

from .writer import NativeChainWriter, native_available

__all__ = ["NativeChainWriter", "native_available"]
