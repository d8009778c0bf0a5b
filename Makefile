# Test/dev targets.  Tests run on the CPU (8 virtual devices for the
# sharding tests); `smoke` and `bench` need the GPU.

TEST_ENV := JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8

# per-file subprocesses with segfault retry: this host's XLA:CPU compiler
# crashes sporadically (see tools/run_suite.py) and would kill a single
# pytest process mid-suite
test:
	$(TEST_ENV) python tools/run_suite.py -m "not slow"

test-all:
	$(TEST_ENV) python tools/run_suite.py

native:
	$(MAKE) -C goicp_tpu/native

smoke:
	python chip_smoke.py

bench:
	python bench.py

.PHONY: test test-all native smoke bench
