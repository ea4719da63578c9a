"""The port's analytic roofline on the CPU against the reference:
`hbm_floor_bytes` on every (arch, shape) cell of the registry over four
mesh shapes, `RooflineTerms` / `roofline_terms` under the same inputs and
constants, the FLOP counter on a known product, `MeshShape`; and that the
port's new modules import neither jax nor anything of `repro`.

Tolerance: `hbm_floor_bytes` to a relative 1e-12 (the same float64
arithmetic; only the order of a few products may differ); the terms to a
relative 1e-12."""
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.configs import registry as jregistry  # noqa: E402
from repro.launch import hbm_model as jhbm  # noqa: E402
from repro.launch import roofline as jroofline  # noqa: E402
from repro.models.api import build_bundle as jax_build_bundle  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch import hbm_model, roofline  # noqa: E402
from repro_torch.launch.mesh import MeshShape  # noqa: E402
from repro_torch.models.api import build_bundle  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-12
CELLS = [(arch, shape) for arch in jregistry.arch_ids()
         for shape in jregistry.shapes_for(arch)]
MESHES = [(("data", "model"), (1, 1)), (("data", "model"), (4, 2)),
          (("data", "model"), (16, 16)),
          (("pod", "data", "model"), (2, 16, 16))]


@pytest.fixture(scope="module")
def bundles():
    """Each arch's bundle in both packages (no weights are made)."""
    return {arch: (build_bundle(arch, device="cpu"), jax_build_bundle(arch))
            for arch in jregistry.arch_ids()}


def test_the_registry_has_the_reference_cells():
    assert len(CELLS) == 40
    assert [(a, s) for a in registry.arch_ids()
            for s in registry.shapes_for(a)] == CELLS


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_hbm_floor_bytes_equals_the_reference(arch, shape, bundles):
    """Every mesh shape, the reference reading it through an object with
    `.size` and `.shape` as it reads a jax Mesh."""
    mine, theirs = bundles[arch]
    for names, sizes in MESHES:
        mesh = MeshShape(names, sizes)
        ref_mesh = types.SimpleNamespace(size=mesh.size,
                                         shape=dict(zip(names, sizes)))
        got = hbm_model.hbm_floor_bytes(mine, shape, mesh)
        want = jhbm.hbm_floor_bytes(theirs, shape, ref_mesh)
        assert isinstance(got, float) and got > 0
        assert got == pytest.approx(want, rel=RTOL, abs=0), (names, sizes)


def test_long_500k_floor_on_one_card(bundles):
    """qwen2-1.5b's long_500k decode step on one device: 18,119,724,032
    bytes (the bf16 cache of 28 x 2 x 524,288 x 2 x 128 elements, the bf16
    weights, 8 model-width rows), 5.41 ms at the card's 3.35 TB/s."""
    got = hbm_model.hbm_floor_bytes(bundles["qwen2-1.5b"][0], "long_500k",
                                    MeshShape(("data", "model"), (1, 1)))
    assert got == 18_119_724_032
    terms = roofline.roofline_terms(0.0, got, 1)
    assert terms.dominant == "memory"
    assert terms.bound_s == pytest.approx(got / 3.35e12, rel=RTOL)


def test_roofline_terms_equal_the_reference_under_the_same_constants(
        monkeypatch):
    """The reference given the card's constants (its `ici_bw` is NVLink
    here), a cost dict and an HLO line with one all-reduce; the port the
    same FLOPs, bytes and that collective."""
    monkeypatch.setattr(jroofline, "HW", {
        "flops_bf16": roofline.HW["flops_bf16"],
        "hbm_bw": roofline.HW["hbm_bw"], "ici_bw": roofline.HW["nvlink_bw"]})
    hlo = "  %ar = bf16[1024,256]{1,0} all-reduce(bf16[1024,256] %x)\n"
    coll = jroofline.collective_bytes(hlo)
    assert coll == {"all-reduce": 1024 * 256 * 2}
    for flops, nbytes, chips in ((3.1e12, 1.8e10, 1), (7.0e14, 2.0e9, 8),
                                 (0.0, 0.0, 4)):
        want = jroofline.roofline_terms(
            {"flops": flops, "bytes accessed": nbytes}, hlo, chips,
            model_flops=flops / 2)
        got = roofline.roofline_terms(flops, nbytes, chips,
                                      coll_bytes=sum(coll.values()),
                                      model_flops=flops / 2)
        assert got.coll_breakdown == {}    # until the multi-card dry run
        for field in ("flops", "hbm_bytes", "coll_bytes", "chips",
                      "compute_s", "memory_s", "collective_s",
                      "model_flops"):
            assert getattr(got, field) == pytest.approx(
                getattr(want, field), rel=RTOL, abs=0), field
        assert got.dominant == want.dominant
        assert got.bound_s == pytest.approx(want.bound_s, rel=RTOL, abs=0)
        assert got.useful_fraction == want.useful_fraction
        assert got.row() == pytest.approx(want.row(), rel=RTOL, abs=0)


def test_hw_holds_the_h100_data_sheet():
    """The card's data-sheet rates, and the compute term on the bf16
    tensor cores' peak."""
    assert roofline.HW == {"flops_bf16": 989e12, "flops_tf32": 495e12,
                           "flops_f32": 67e12, "hbm_bw": 3.35e12,
                           "nvlink_bw": 450e9}
    terms = roofline.roofline_terms(989e12, 0.0, 1)
    assert terms.compute_s == 1.0 and terms.dominant == "compute"


def test_count_flops_counts_a_known_matmul_exactly():
    a, b = torch.randn(3, 5, 7), torch.randn(7, 11)
    out, flops = roofline.count_flops(torch.matmul, a, b)
    assert torch.equal(out, a @ b)
    assert flops == 2 * 3 * 5 * 7 * 11
    _, flops = roofline.count_flops(lambda x: (x + 1).sum(), a)
    assert flops == 0                  # elementwise work is not counted


def test_mesh_shape():
    mesh = MeshShape(("pod", "data", "model"), (2, 16, 16))
    assert mesh.size == 512
    assert mesh.shape == {"pod": 2, "data": 16, "model": 16}
    assert list(mesh.shape) == ["pod", "data", "model"]
    assert MeshShape(("data",), (4,)).shape.get("model", 1) == 1
    for names, sizes in ((("a", "a"), (1, 2)), (("a",), (1, 2)),
                         (("a",), (0,))):
        with pytest.raises(ValueError):
            MeshShape(names, sizes)


def test_new_modules_import_no_jax_and_nothing_of_repro():
    code = ("import sys\n"
            "import repro_torch.launch.roofline\n"
            "import repro_torch.launch.hbm_model\n"
            "import repro_torch.distributed.context_parallel\n"
            "import repro_torch.nn.attention\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"
