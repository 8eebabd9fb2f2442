"""Build the native extensions of bmsparse.

    python setup.py build_ext --inplace     (or: make native)

The compute path is JAX/XLA/Pallas; the native layer covers the host-side
runtime pieces the reference implements in C++ (file ingestion,
ref: src/bmSpMatrix.cu:112-161 / src/reader.cu).
"""

import numpy as np
from setuptools import Extension, setup

setup(
    name="bmsparse-native",
    version="0.1.0",
    ext_modules=[
        Extension(
            "bmsparse.io._mmparse",
            sources=["native/mmparse.cpp"],
            include_dirs=[np.get_include()],
            extra_compile_args=["-O3", "-std=c++17", "-Wall"],
            language="c++",
        ),
    ],
)
