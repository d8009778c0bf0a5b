"""Test configuration: run JAX on a virtual 8-device CPU mesh so sharding
tests work without accelerator hardware (and stay deterministic).

Tests that need the GPU take the `gpu_device` fixture: it skips them, with a
reason, where JAX finds no GPU.  The decision is made per test, never while
a module is imported, so every pytest-xdist worker collects the same tests.
On a machine with the card, run them with
    python -m pytest tests/ -m gpu
(run with JAX_PLATFORMS=cuda there: this conftest pins the CPU unless
JAX_PLATFORMS names another platform).

Tests of the parsers read `data_tree`, a seeded reference-style data tree
written to a temporary directory.  The few tests that compare with the
reference's own golden outputs take `ref_dir`, a checkout of the reference
data named by GOICP_REFERENCE_DIR, and skip where it is absent.
"""

import os

import numpy as np

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

# exact f32 matmuls (NN distance matrices rely on it)
jax.config.update("jax_default_matmul_precision", "highest")

import pytest  # noqa: E402


@pytest.fixture(scope="session")
def ref_dir():
    """The reference's data checkout (golden outputs); skips without it."""
    path = os.environ.get("GOICP_REFERENCE_DIR", "")
    if not os.path.isdir(path):
        pytest.skip("the reference's data files are absent "
                    "(set GOICP_REFERENCE_DIR to a checkout of them)")
    return path


# sizes of the seeded data tree (BO1 pair 1's cavity sizes)
TREE_SIZES = {"2x86_3": 238, "1eq2_6": 306}
TREE_PAIRS = 5


@pytest.fixture(scope="session")
def data_tree(tmp_path_factory):
    """A seeded reference-style data tree: cavities/*.mol2 with the
    MOLECULE-header atom count, cfpfh/*.cfpfh (41 bins per point), the
    similar and dissimilar BO1 TSVs, and chains/<id>_protein.mol2 with
    backbone and side-chain atoms.  Returns (root, truth) where truth maps
    each cavity id to its (coords, prop_idx, cfpfh) as written."""
    from goicp_tpu.io.mol2 import write_mol2
    from goicp_tpu.io.tsv import write_pair_list

    root = tmp_path_factory.mktemp("bo1")
    for sub in ("cavities", "cfpfh", "chains"):
        (root / sub).mkdir()
    rng = np.random.default_rng(2024)
    truth = {}
    for cav, n in TREE_SIZES.items():
        coords = np.round(rng.uniform(-20.0, 100.0, size=(n, 3)), 6)
        props = rng.integers(0, 9, n).astype(np.int32)
        desc = rng.uniform(0.0, 60.0, size=(n, 41))
        write_mol2(str(root / "cavities" / f"{cav}_cavity6.mol2"), coords,
                   props)
        np.savetxt(root / "cfpfh" / f"{cav}_cavity6.cfpfh", desc)
        truth[cav] = (coords, props, desc)
        # protein chain: every 4th atom a backbone name (N, CA, C, O), the
        # rest side-chain names (PROP_NAMES indices)
        pprops = rng.choice([0, 3, 4, 6, 7], n).astype(np.int32)
        pprops[::4] = np.resize([1, 5, 8, 2], len(pprops[::4]))
        write_mol2(str(root / "chains" / f"{cav}_protein.mol2"), coords,
                   pprops)
    ids = list(TREE_SIZES)
    for kind in ("similar", "dissimilar"):
        write_pair_list(str(root / f"cavities_{kind}_BO1_clean.tsv"),
                        [(ids[0], ids[1])] * TREE_PAIRS)
    return str(root), truth


@pytest.fixture
def gpu_device():
    """The first GPU JAX sees; skips the test where there is none."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {devs[0].platform}")
    return devs[0]
