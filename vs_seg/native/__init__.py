"""Native (C++) host-pipeline components.

`decoder` exposes the zlib-based NIFTI payload decoder; it compiles the
shared library on first use (g++ + zlib, both baked into the image) and
falls back to the pure-Python path transparently if compilation fails.
"""

from vs_seg.native.decoder import read_file_bytes, native_available
