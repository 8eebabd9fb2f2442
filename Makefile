# bmsparse build/test entry points (the reference's Makefile analogue,
# ref: /root/reference/Makefile — nvcc targets become native-extension and
# test/bench targets here; the JAX compute path needs no ahead-of-time
# compilation).

PY ?= python

.PHONY: all native test bench clean

all: native

native:
	$(PY) setup.py build_ext --inplace

test:
	$(PY) -m pytest tests/ -x -q

bench:
	$(PY) bench.py

clean:
	rm -rf build bmsparse/io/_mmparse*.so
