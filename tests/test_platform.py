"""Where the program keeps its compile cache, what it reports about its
device, and the trace reduction that turns a profile into device metrics."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import goicp_tpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import json, os, jax, jax.numpy as jnp
import goicp_tpu
jax.jit(lambda x: jnp.sin(x) @ x)(jnp.ones((64, 64))).block_until_ready()
print(json.dumps({"dir": jax.config.jax_compilation_cache_dir,
                  "repo_dir": goicp_tpu.CACHE_DIR}))
"""


def _probe(env_overrides, drop=()):
    env = {k: v for k, v in os.environ.items()
           if k not in drop and k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(env_overrides)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _listing(path):
    return sorted(os.listdir(path)) if os.path.isdir(path) else None


def test_compile_cache_honours_env_dir(tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: the entries land there and nowhere
    in the checkout."""
    before = _listing(goicp_tpu.CACHE_DIR)
    cc = tmp_path / "cc"
    got = _probe({"JAX_COMPILATION_CACHE_DIR": str(cc),
                  "JAX_PLATFORMS": "cpu",
                  "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS": "0"})
    assert got["dir"] == str(cc)
    assert cc.is_dir() and os.listdir(cc), "no cache entry written"
    assert _listing(goicp_tpu.CACHE_DIR) == before


def test_compile_cache_defaults_to_checkout_dir():
    """Unset: the cache is the fixed <checkout>/.jax_cache (no salt), on
    any platform but a pinned XLA:CPU, where it stays off."""
    got = _probe({"JAX_PLATFORMS": "cpu"})
    assert got["dir"] is None
    # JAX_PLATFORMS unset: the checkout directory is configured (read
    # only, without compiling: here JAX would fall back to the CPU)
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "JAX_COMPILATION_CACHE_DIR")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    code = ("import jax, goicp_tpu, json; print(json.dumps("
            "[jax.config.jax_compilation_cache_dir, goicp_tpu.CACHE_DIR]))")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    cfg_dir, repo_dir = json.loads(out.stdout.strip().splitlines()[-1])
    assert cfg_dir == repo_dir == os.path.join(REPO, ".jax_cache")


def test_device_summary_and_card_line():
    from goicp_tpu.utils.device import (card_name_and_power_limit,
                                        device_summary, peak_bytes)
    dev = device_summary()
    assert dev == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())}
    assert isinstance(card_name_and_power_limit(), str)
    assert peak_bytes() is None or peak_bytes() >= 0


def test_config_file_round_trip(tmp_path):
    import dataclasses

    from goicp_tpu.config import GoICPConfig
    from goicp_tpu.pipeline.demo import DEMO_CONFIG
    for cfg in (GoICPConfig(),
                dataclasses.replace(DEMO_CONFIG, icp_seeds=4,
                                    margin_frac=0.9)):
        path = str(tmp_path / "config.txt")
        cfg.to_file(path)
        assert GoICPConfig.from_file(path) == cfg


def test_trace_summary_attributes_scope(tmp_path):
    from goicp_tpu.utils import profiling

    @jax.jit
    def f(x):
        with jax.named_scope("scoped_part"):
            y = jnp.sin(x) @ x
        return jnp.cos(y).sum()

    x = jnp.ones((256, 256))
    f(x).block_until_ready()
    hlo = f.lower(x).compile().as_text()
    ops = profiling.hlo_ops_in_scope(hlo, "scoped_part")
    assert ops, "no HLO op carries the scope"
    with jax.profiler.trace(str(tmp_path)):
        with jax.profiler.TraceAnnotation("window"):
            for _ in range(3):
                f(x).block_until_ready()
    # XLA:CPU runs its ops on host threads: reduce the host plane
    s = profiling.summarize_trace(str(tmp_path), plane_prefix="/host:CPU",
                                  window="window", scope="scoped_part",
                                  scope_ops=ops)
    assert 0 < s["busy_ns"] <= s["window_ns"]
    assert 0.0 <= s["idle_share"] < 1.0
    assert s["top_ops"] and s["n_events"] > 0
    assert 0 < s["scope_ns"] <= s["busy_ns"]


def test_hlo_ops_in_scope_sees_transformed_scopes():
    from goicp_tpu.utils.profiling import hlo_ops_in_scope
    hlo = "\n".join([
        '%a.1 = f32[] add(x, y), metadata={op_name="jit(f)/while/body/'
        'vmap(bound_eval)/sub"}',
        'ROOT %fusion.2 = f32[] fusion(z), metadata={op_name="jit(f)/'
        'bound_eval/mul"}',
        '%b.3 = f32[] add(x, y), metadata={op_name="jit(f)/other/add"}',
        '%c.4 = f32[] add(x, y), metadata={op_name="jit(f)/not_bound_eval/'
        'add"}',
    ])
    assert hlo_ops_in_scope(hlo, "bound_eval") == {"a.1", "fusion.2"}


def test_union_of_intervals():
    from goicp_tpu.utils.profiling import _union_ns
    assert _union_ns([(0, 10), (5, 15), (20, 30), (30, 31)]) == 26
    assert _union_ns([]) == 0


def test_native_library_rebuilds_when_stale(tmp_path, monkeypatch):
    from goicp_tpu import native
    lib = tmp_path / "lib.so"
    src = tmp_path / "a.cpp"
    src.write_text("x")
    monkeypatch.setattr(native, "_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_LIB_PATH", str(lib))
    monkeypatch.setattr(native, "_SOURCES", ("a.cpp",))
    assert native._stale()                      # missing
    lib.write_text("y")
    os.utime(src, (1, 1))
    assert not native._stale()                  # newer than its sources
    os.utime(src, None)
    os.utime(lib, (1, 1))
    assert native._stale()                      # older than a source


def test_bench_refuses_without_gpu(capsys):
    """bench.py measures only on a GPU: elsewhere it exits non-zero and
    prints no number."""
    sys.path.insert(0, REPO)
    import bench
    assert bench.main() != 0
    captured = capsys.readouterr()
    assert captured.out == ""
    assert "needs a GPU" in captured.err


@pytest.mark.gpu
def test_gpu_device_reports_kind(gpu_device):
    """On the card: JAX sees a GPU with a device kind, and the summary
    agrees (skips on the CPU)."""
    from goicp_tpu.utils.device import device_summary
    assert gpu_device.device_kind
    assert device_summary()["platform"] == "gpu"
    x = jax.device_put(np.ones(4, np.float32), gpu_device)
    assert float(jnp.sum(x)) == 4.0
