"""The port's launch tools against the reference's: the analytic cost model
(``launch/analytic.py``), the roofline (``launch/roofline.py``: parameter
counts from the meta device, a cell's terms with the reference's constants
passed in), the mesh's refusals, and the markdown link checker
(``tools/check_links.py``)."""
import dataclasses
from pathlib import Path

import pytest
import torch

from repro.configs import SHAPES as R_SHAPES
from repro.configs import get_config as r_get_config
from repro.launch import analytic as r_analytic
from repro.launch import roofline as r_roofline
from repro.tools import check_links as r_check_links
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.launch import analytic, roofline
from repro_torch.launch.mesh import dp_axes, make_mesh, make_production_mesh
from repro_torch.tools import check_links

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
MESHES = [(1, 1, 1), (256, 16, 16), (512, 32, 16)]  # (chips, dp, tp)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_analytic_cost_equals_the_reference(arch):
    for shape in SHAPES:
        for chips, dp, tp in MESHES:
            got = analytic.analytic_cost(get_config(arch), SHAPES[shape],
                                         analytic.MeshInfo(chips=chips, dp=dp, tp=tp))
            want = r_analytic.analytic_cost(r_get_config(arch), R_SHAPES[shape],
                                            r_analytic.MeshInfo(chips=chips, dp=dp, tp=tp))
            assert dataclasses.asdict(got) == dataclasses.asdict(want), (shape, chips)


@pytest.fixture(scope="module")
def ref_param_counts():
    return {a: r_roofline.param_counts(a) for a in sorted(ARCHS)}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_counts_equal_the_reference(arch, ref_param_counts):
    assert roofline.param_counts(arch) == ref_param_counts[arch]


def _records():
    recs = []
    for i, arch in enumerate(sorted(ARCHS)):
        for j, shape in enumerate(SHAPES):
            recs.append(dict(arch=arch, shape=shape, mesh="16x16", kind="lower",
                             status="ok", n_devices=256 if (i + j) % 2 else 512,
                             hlo_flops=1.5e15 * (i + 1), hlo_bytes=2.5e12 * (j + 1),
                             collective_total=3.0e10 * (i + j + 1),
                             collective_bytes={"all-reduce": 2.0e10, "all-gather": 1.0e10}))
    recs.append(dict(arch="mixtral-8x7b", shape="long_500k", mesh="16x16", kind="lower",
                     status="skipped", reason="pure O(L^2) full attention"))
    return recs


@pytest.mark.parametrize("analytic_model", [True, False])
def test_analyse_cell_equals_the_reference(analytic_model, ref_param_counts):
    hw = roofline.Hardware(r_roofline.PEAK_FLOPS, r_roofline.HBM_BW, r_roofline.LINK_BW)
    for rec in _records():
        got = roofline.analyse_cell(rec, ref_param_counts, analytic=analytic_model, hw=hw)
        want = r_roofline.analyse_cell(rec, ref_param_counts, analytic=analytic_model)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), rec["arch"]
        assert (got.step_time, got.roofline_fraction) == (want.step_time, want.roofline_fraction)
    cells = [roofline.analyse_cell(r, ref_param_counts, analytic=analytic_model, hw=hw)
             for r in _records()]
    table = roofline.markdown_table(cells)
    assert table.count("\n") == len(cells) + 1 and "skipped" in table


def test_roofline_defaults_to_the_h100(ref_param_counts):
    assert roofline.H100 == roofline.Hardware(989e12, 3.35e12, 450e9)
    rec = _records()[0]
    cost = analytic.analytic_cost(get_config(rec["arch"]), SHAPES[rec["shape"]],
                                  analytic.MeshInfo(chips=512, dp=32, tp=16))
    cell = roofline.analyse_cell(rec, ref_param_counts)
    assert cell.compute_s == cost.flops / 989e12
    assert cell.memory_s == cost.hbm_bytes / 3.35e12
    assert cell.collective_s == cost.coll_bytes / 450e9


def test_mesh_refuses_a_world_of_another_size():
    mesh = make_mesh((1,), ("data",), device="cpu")
    assert mesh.shape == {"data": 1} and mesh.get_group("data") is None
    assert mesh.local_rank("data") == 0 and mesh.ranks == (0,)
    assert dp_axes(make_mesh((1, 1), ("data", "model"), device="cpu")) == ("data",)
    with pytest.raises(ValueError, match="256 ranks"):
        make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="512 ranks"):
        make_production_mesh(multi_pod=True, device="cpu")
    with pytest.raises(ValueError):
        make_mesh((2,), ("data", "model"), device="cpu")


def test_mesh_asks_for_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        make_mesh((1,), ("data",))


@pytest.mark.parametrize("paths", [["README.md", "docs"], ["docs/architecture.md"]])
def test_check_links_gives_the_reference_output(paths, monkeypatch, capsys):
    monkeypatch.chdir(REPO)
    rc = check_links.main(paths)
    got = capsys.readouterr()
    rc_ref = r_check_links.main(paths)
    want = capsys.readouterr()
    assert (rc, got.out, got.err) == (rc_ref, want.out, want.err)
    assert check_links.slugify("A `code` Heading!") == r_check_links.slugify("A `code` Heading!")


def test_check_links_finds_a_broken_link(tmp_path, monkeypatch, capsys):
    """A broken path is reported.  Both packages report a same-file anchor
    under a relative path as escaping the repository (the path is not
    resolved before the check): the copy keeps that."""
    (tmp_path / "a.md").write_text("# Top\n[ok](#top) [bad](missing.md) [anchor](#nowhere)\n")
    monkeypatch.chdir(tmp_path)
    rc = check_links.main(["a.md"])
    got = capsys.readouterr()
    assert (rc, got.out, got.err) == (r_check_links.main(["a.md"]), *capsys.readouterr())
    assert "a.md: broken link -> missing.md" in got.err.splitlines()
