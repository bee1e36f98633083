"""The port's point-cloud fusion and visualisation vs the JAX package's, on
the CPU and on identical files: dmvsnet_tpu_torch.fusion (ply, geometry_np,
pcd, dypcd) against dmvsnet_tpu.fusion, run_visualization against the JAX
one, and the port's run_test with fusion (``--test`` through the CLI) whose
PLY must equal the JAX package's fusion of the same depth maps.

Equality is exact: the copies run the same numpy code, so the PLYs, mask
PNGs and PNG renders are compared byte for byte and the averaged depth PFMs
value for value.
"""

import filecmp
import os
import shutil

import numpy as np
import pytest
from PIL import Image

from dmvsnet_tpu.data import io as jio
from dmvsnet_tpu.engine.evaluate import run_visualization as jrun_visualization
from dmvsnet_tpu.fusion import dypcd_filter as jdypcd_filter
from dmvsnet_tpu.fusion import geometry_np as jG
from dmvsnet_tpu.fusion import pcd_filter as jpcd_filter
from dmvsnet_tpu.fusion.ply import read_ply as jread_ply
from dmvsnet_tpu.fusion.ply import write_ply as jwrite_ply
from dmvsnet_tpu.utils import synthetic as jsyn
from dmvsnet_tpu_torch import cli
from dmvsnet_tpu_torch import fusion as tfusion
from dmvsnet_tpu_torch.data import io
from dmvsnet_tpu_torch.engine.evaluate import ply_path, run_visualization
from dmvsnet_tpu_torch.fusion import geometry_np as G
from dmvsnet_tpu_torch.fusion.ply import read_ply, write_ply
from dmvsnet_tpu_torch.utils import synthetic

DEPTH = 600.0
H, W, V = 96, 128, 4


def test_the_package_reexports_the_filters():
    assert tfusion.pcd_filter.__module__ == "dmvsnet_tpu_torch.fusion.pcd"
    assert tfusion.dypcd_filter.__module__ == "dmvsnet_tpu_torch.fusion.dypcd"
    assert set(tfusion.TANK_SCENE_CONFIG) == set(__import__(
        "dmvsnet_tpu.fusion", fromlist=["TANK_SCENE_CONFIG"]).TANK_SCENE_CONFIG)


def test_ply_bytes_equal_the_jax_writer(tmp_path, rng):
    xyz = rng.normal(size=(257, 3)).astype(np.float32)
    rgb = rng.integers(0, 255, size=(257, 3)).astype(np.uint8)
    ours, theirs = str(tmp_path / "a.ply"), str(tmp_path / "b.ply")
    write_ply(ours, xyz, rgb)
    jwrite_ply(theirs, xyz, rgb)
    assert filecmp.cmp(ours, theirs, shallow=False)
    for read in (read_ply, jread_ply):
        x2, r2 = read(ours)
        np.testing.assert_array_equal(x2, xyz)
        np.testing.assert_array_equal(r2, rgb)


@pytest.mark.parametrize("cams", ["translate", "orbit"])
def test_geometric_consistency_equals_the_jax_one(rng, cams):
    """Both round-trip checks on a pair of depth maps with noise, under
    translated and multi-axis rotated cameras."""
    if cams == "orbit":
        stack = synthetic.orbit_camera_stack(2, 150.0, 150.0, W / 2, H / 2, depth=DEPTH)
    else:
        stack = np.stack([synthetic.camera_stack(150.0, 150.0, W / 2, H / 2, tx=-12.0 * i)
                          for i in range(2)])
    (ref_e, ref_k), (src_e, src_k) = ((c[0], c[1, :3, :3]) for c in stack)
    ref_d = (DEPTH + rng.normal(0, 3, (H, W))).astype(np.float32)
    src_d = (DEPTH + rng.normal(0, 3, (H, W))).astype(np.float32)
    args = (ref_d, ref_k, ref_e, src_d, src_k, src_e)
    for a, b in zip(G.check_geometric_consistency(*args),
                    jG.check_geometric_consistency(*args)):
        np.testing.assert_array_equal(a, b)
    masks, last, rep = G.check_geometric_consistency_dynamic(*args, 0.25, 1 / 1300)
    jmasks, jlast, jrep = jG.check_geometric_consistency_dynamic(*args, 0.25, 1 / 1300)
    assert len(masks) == len(jmasks) and 0 < last.mean() < 1
    for a, b in zip((*masks, last, rep), (*jmasks, jlast, jrep)):
        np.testing.assert_array_equal(a, b)


def _write_outputs_tree(root, scan, kind, seed=0):
    """A test-runner-format outputs tree for a textured plane seen by V
    translated views, as tests/test_fusion.py writes it.  "consistent": every
    depth map is the plane, per-stage confidences random; "inconsistent":
    the sources' right halves are 25% too deep and the depths carry noise."""
    r = np.random.default_rng(seed)
    imgs, cams, _ = jsyn.render_plane_views(H, W, V, DEPTH, seed=3)
    datapath, outdir = os.path.join(root, "data"), os.path.join(root, "out")
    pairs = []
    for v in range(V):
        os.makedirs(os.path.join(outdir, scan, "images"), exist_ok=True)
        Image.fromarray((imgs[v] * 255).astype(np.uint8)).save(
            os.path.join(outdir, scan, "images", f"{v:08d}.jpg"), quality=97)
        io.write_cam_file(os.path.join(outdir, scan, "cams", f"{v:08d}_cam.txt"), cams[v])
        depth = np.full((H, W), DEPTH, np.float32)
        if kind == "inconsistent":
            depth += r.normal(0, 1.0, (H, W)).astype(np.float32)
            if v:
                depth[:, W // 2:] *= 1.25
        io.save_pfm(os.path.join(outdir, scan, "depth_est", f"{v:08d}.pfm"), depth)
        for suffix in ("", "_stage1", "_stage2"):
            io.save_pfm(os.path.join(outdir, scan, "confidence", f"{v:08d}{suffix}.pfm"),
                        r.uniform(0.0, 1.0, (H, W)).astype(np.float32))
        pairs.append((v, [s for s in range(V) if s != v]))
    io.write_pair_file(os.path.join(datapath, scan, "pair.txt"), pairs)
    return datapath, outdir


def _same_tree(a, b):
    """Every file of fusion's outputs under a equals its counterpart under b:
    PLYs and mask PNGs byte for byte, PFMs value for value."""
    files = sorted(os.path.relpath(os.path.join(d, f), a)
                   for d, _, fs in os.walk(a) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), b)
                           for d, _, fs in os.walk(b) for f in fs)
    for rel in files:
        if rel.endswith(".pfm"):
            np.testing.assert_array_equal(io.read_pfm(os.path.join(a, rel))[0],
                                          io.read_pfm(os.path.join(b, rel))[0])
        else:
            assert filecmp.cmp(os.path.join(a, rel), os.path.join(b, rel), shallow=False), rel
    return files


@pytest.mark.parametrize("method", ["pcd", "dypcd"])
@pytest.mark.parametrize("kind,scan", [("consistent", "scan7"), ("inconsistent", "scan7"),
                                       ("consistent", "Horse")])
def test_filters_equal_the_jax_filters(tmp_path, method, kind, scan):
    """pcd_filter / dypcd_filter of both packages on copies of one outputs
    tree: the PLY, the mask PNGs and dypcd's _averaged.pfm cache equal.
    "Horse" is a TANK_SCENE_CONFIG scene, whose per-scene thresholds replace
    the ones passed in; a second dypcd run reads its cache.  The path that
    run_test's summary gives (evaluate.ply_path) names the cloud the filter
    wrote, for a scanN and a T&T scene name."""
    datapath, outdir = _write_outputs_tree(str(tmp_path / "a"), scan, kind)
    theirs = str(tmp_path / "b")
    shutil.copytree(outdir, theirs)
    args = {"datapath": datapath, "conf": (0.0, 0.0, 0.3), "thres_view": 2,
            "dist_base": 0.25, "rel_diff_base": 1 / 1300, "num_stage": 3}
    ours_f, theirs_f = ((tfusion.pcd_filter, jpcd_filter) if method == "pcd"
                        else (tfusion.dypcd_filter, jdypcd_filter))
    ours_f(dict(args, outdir=outdir), [scan], 1)
    theirs_f(dict(args, outdir=theirs), [scan], 1)
    files = _same_tree(outdir, theirs)
    ply = os.path.relpath(ply_path(outdir, scan), outdir)
    assert ply == ("pcd/mvsnet007_l3.ply" if scan == "scan7" else f"pcd/{scan}.ply")
    assert ply in files and f"{scan}/mask/00000000_final.png" in files
    xyz, _ = read_ply(os.path.join(outdir, ply))
    assert 0 < len(xyz) < V * H * W
    if kind == "consistent":
        np.testing.assert_allclose(xyz[:, 2], DEPTH, atol=0.5)
    if scan == "Horse":
        # the scene's own thresholds (0.15, 0.4, 0.8) keep fewer points
        # than the 0/0/0.3 passed in
        loose = str(tmp_path / "loose")
        shutil.copytree(os.path.join(tmp_path / "a", "data", scan),
                        os.path.join(tmp_path / "a", "data", "scan8"))
        shutil.copytree(os.path.join(theirs, scan), os.path.join(loose, "scan8"),
                        ignore=shutil.ignore_patterns("mask", "*_averaged.pfm"))
        ours_f(dict(args, outdir=loose), ["scan8"], 1)
        assert len(read_ply(ply_path(loose, "scan8"))[0]) > len(xyz)
    if method == "dypcd":
        # from the cache (whose float32 depths move the points by an ulp
        # against the first run's, in both packages)
        ours_f(dict(args, outdir=outdir), [scan], 1)
        theirs_f(dict(args, outdir=theirs), [scan], 1)
        _same_tree(outdir, theirs)


@pytest.mark.parametrize("case", ["depths", "nan_and_flat", "float64", "ints"])
def test_colormap_equals_matplotlib(rng, case):
    """engine/colormap.magma_rgb against matplotlib's ScalarMappable with
    the magma map on the same inputs: equal colours, also for values below
    and above the range, NaN, a flat map and other dtypes."""
    import matplotlib.cm as cm
    import matplotlib.colors as mcolors

    from dmvsnet_tpu_torch.engine.colormap import magma_rgb

    values = {"depths": rng.uniform(400, 900, (40, 50)).astype(np.float32),
              "nan_and_flat": np.concatenate([np.full((3, 8), 2.5), np.full((1, 8), np.nan),
                                              rng.uniform(0, 5, (3, 8))]).astype(np.float32),
              "float64": rng.normal(0, 1e-3, (30, 20)),
              "ints": rng.integers(0, 1000, (20, 20)).astype(np.int32)}[case]
    lo, hi = np.nanpercentile(values, 5), np.nanpercentile(values, 95)
    want = cm.ScalarMappable(norm=mcolors.Normalize(vmin=lo, vmax=hi),
                             cmap="magma").to_rgba(values)[..., :3]
    np.testing.assert_array_equal(magma_rgb(values, lo, hi), want)
    flat = np.full((4, 4), 3.0, np.float32)
    np.testing.assert_array_equal(
        magma_rgb(flat, flat.min(), flat.max()),
        cm.ScalarMappable(norm=mcolors.Normalize(vmin=flat.min(), vmax=flat.max()),
                          cmap="magma").to_rgba(flat)[..., :3])


def test_visualization_bytes_equal_the_jax_one(tmp_path, rng):
    pfm = str(tmp_path / "d.pfm")
    io.save_pfm(pfm, rng.uniform(400, 900, (48, 64)).astype(np.float32))
    ours = run_visualization(pfm, str(tmp_path / "ours"))
    theirs = jrun_visualization(pfm, str(tmp_path / "theirs"))
    assert ours == str(tmp_path / "ours" / "depth.png")
    assert filecmp.cmp(ours, theirs, shallow=False)
    assert np.asarray(Image.open(ours)).shape == (48, 64, 3)
    # and through the CLI, which needs no device for it
    summary = cli.main(["--vis", "--depth_path", pfm, "--depth_img_save_dir",
                        str(tmp_path / "cli")])
    assert summary == {"mode": "vis", "png": str(tmp_path / "cli" / "depth.png")}
    assert filecmp.cmp(summary["png"], theirs, shallow=False)


@pytest.mark.parametrize("method", ["pcd", "dypcd"])
def test_run_test_fuses_as_the_jax_package(tmp_path, method):
    """The CLI's --test at 64x96 / 3 views on --device cpu with fusion:
    a parseable PLY in the summary, and that PLY and the masks equal
    to the JAX package's fusion of the same depth maps."""
    data, out = str(tmp_path / "data"), str(tmp_path / "out")
    synthetic.write_eval_scene(data, "scan1", height=64, width=96, n_views=3)
    summary = cli.main([
        "--test", "--preset", "dtu_test", "--device", "cpu", "--datapath", data,
        "--testlist", "scan1", "--outdir", out, "--ndepths", "8", "8", "8",
        "--max_h", "64", "--max_w", "96", "--num_view", "3", "--filter_method", method,
        "--thres_view", "1", "--conf", "0", "0", "0", "--num_worker", "1",
        # random weights: loose thresholds so that some pixels agree
        "--dist_base", "4", "--rel_diff_base", "0.02",
    ])
    assert summary["maps"] == 3 and summary["fusion_seconds"] > 0
    assert summary["ply"] == [os.path.join(out, "pcd", "mvsnet001_l3.ply")]
    xyz, rgb = read_ply(summary["ply"][0])
    assert len(xyz) > 0 and xyz.shape == rgb.shape and np.isfinite(xyz).all()

    theirs = str(tmp_path / "theirs")
    shutil.copytree(os.path.join(out, "scan1"), os.path.join(theirs, "scan1"),
                    ignore=shutil.ignore_patterns("mask", "*_averaged.pfm"))
    args = {"datapath": data, "outdir": theirs, "conf": (0.0, 0.0, 0.0), "thres_view": 1,
            "dist_base": 4.0, "rel_diff_base": 0.02, "num_stage": 3}
    (jpcd_filter if method == "pcd" else jdypcd_filter)(args, ["scan1"], 1)
    _same_tree(out, theirs)
    assert len(xyz) == len(jread_ply(os.path.join(theirs, "pcd", "mvsnet001_l3.ply"))[0])


def test_run_test_without_fusion_reports_none(tmp_path):
    data = str(tmp_path / "data")
    synthetic.write_eval_scene(data, "scan1", height=64, width=96, n_views=3)
    summary = cli.main([
        "--test", "--preset", "dtu_test", "--device", "cpu", "--datapath", data,
        "--testlist", "scan1", "--outdir", str(tmp_path / "out"), "--ndepths", "8", "8", "8",
        "--max_h", "64", "--max_w", "96", "--num_view", "3", "--filter_method", "none",
    ])
    assert summary["fusion_seconds"] == 0.0 and summary["ply"] == []
    assert not os.path.exists(tmp_path / "out" / "pcd")
