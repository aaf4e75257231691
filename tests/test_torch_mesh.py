"""The tile mesh of vcp_tpu_torch (``parallel.mesh``, the encoder's mesh
path) against vcp_tpu's on the CPU, at tolerance 0.

vcp_tpu's sharded steps and its mesh MP4s run once, in one fresh
subprocess on 8 virtual CPU devices (as ``tests/test_parallel.py`` runs
them: a shard_map compile in a long-lived session can crash XLA:CPU); the
port runs its bands on a mesh of 8 x ``cpu``."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vcp_tpu_torch.codec.h264 import encoder as te
from vcp_tpu_torch.codec.h264.gop_ops import encode_pchunk
from vcp_tpu_torch.ops import motion as mops
from vcp_tpu_torch.ops.motion_cuda import motion_search
from vcp_tpu_torch.parallel import mesh as meshmod
from vcp_tpu_torch.pipeline import executor as t_executor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU8 = [torch.device("cpu")] * 8
# (subpel, deblock, sr) of the sharded P chunk
CASES = ((0, False, 4), (1, True, 4), (2, True, 4), (1, True, 12))
QP, QPC, LAM = 26, 26, 4
EXEC_ARGS = {"speed": ("-c:v libx264 -crf 28 -movflags +faststart", {}),
             "cavlc-medium": ("-c:v libx264 -preset medium -crf 28 "
                              "-movflags +faststart", {"VCP_CABAC": "0"})}

_REFERENCE = r"""
import jax; jax.config.update('jax_platforms', 'cpu')
import os, sys
import numpy as np
root, tests, out_dir = sys.argv[1:4]
sys.path[:0] = [root, tests]
from video_util import synth_video
from vcp_tpu.codec.y4m import write_y4m
from vcp_tpu.parallel.mesh import (encode_iframe_batch_sharded,
                                   encode_pchunk_sharded, make_mesh)
from vcp_tpu.pipeline import executor

CASES = %r
QP, QPC, LAM = %r
mesh = make_mesh(8)
rng = np.random.default_rng(3)
t, b, n = mesh.shape["tile"], mesh.shape["data"], 3
h, w = 32 * t, 64
ys = rng.integers(0, 256, (b, n, h, w)).astype(np.int32)
us = rng.integers(0, 256, (b, n, h // 2, w // 2)).astype(np.int32)
vs = rng.integers(0, 256, (b, n, h // 2, w // 2)).astype(np.int32)
ref_y = np.roll(ys[:, 0], (0, 2, -1), (0, 1, 2)).astype(np.int32)
ref_u = np.roll(us[:, 0], (0, 1, 1), (0, 1, 2)).astype(np.int32)
ref_v = np.roll(vs[:, 0], (0, 1, 1), (0, 1, 2)).astype(np.int32)
out = dict(ys=ys, us=us, vs=vs, ref_y=ref_y, ref_u=ref_u, ref_v=ref_v)
for subpel, deblock, sr in CASES:
    res = encode_pchunk_sharded(mesh, ys, us, vs, ref_y, ref_u, ref_v, QP,
                                QPC, sr, LAM, subpel=subpel, deblock=deblock)
    for name, a in zip(("packed", "ry", "ru", "rv"), res):
        out[f"{name}_{subpel}_{int(deblock)}_{sr}"] = np.asarray(a)
iy = rng.integers(0, 256, (8, 32, 64)).astype(np.int32)
iu = rng.integers(0, 256, (8, 16, 32)).astype(np.int32)
iv = rng.integers(0, 256, (8, 16, 32)).astype(np.int32)
out.update(iy=iy, iu=iu, iv=iv)
for name, a in zip(("iry", "iru", "irv"),
                   encode_iframe_batch_sharded(mesh, iy, iu, iv, QP, QPC)):
    out[name] = np.asarray(a)
np.savez(os.path.join(out_dir, "mesh.npz"), **out)

src = os.path.join(out_dir, "in.y4m")
write_y4m(src, synth_video(96, 128, 10), fps_num=30)   # 8 MB rows
os.environ["VCP_MESH"] = "8"
for label, (args, env) in %r.items():
    os.environ.update(env)
    executor.execute(src, os.path.join(out_dir, label + ".mp4"), args,
                     timeout=600)
    for k in env:
        del os.environ[k]
print("REFERENCE OK")
""" % (CASES, (QP, QPC, LAM), EXEC_ARGS)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """vcp_tpu's outputs, made once in a fresh process on 8 virtual CPU
    devices: the sharded P chunks of ``CASES``, the sharded intra batch
    and the executor MP4s with ``VCP_MESH=8``."""
    out_dir = str(tmp_path_factory.mktemp("mesh_ref"))
    env = dict(os.environ,
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_force_host_platform_device_count=8"),
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [REPO] + os.environ.get("PYTHONPATH", "").split(
                       os.pathsep)))
    r = subprocess.run(
        [sys.executable, "-c", _REFERENCE, REPO,
         os.path.join(REPO, "tests"), out_dir],
        capture_output=True, text=True, timeout=900, env=env)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "REFERENCE OK" in r.stdout
    with np.load(os.path.join(out_dir, "mesh.npz")) as z:
        data = dict(z)
    data["dir"] = out_dir
    return data


def _sharded(ref, subpel, deblock, sr):
    mesh = meshmod.make_mesh(devices=CPU8)
    assert mesh.shape == {"data": 2, "tile": 4}
    return meshmod.encode_pchunk_sharded(
        mesh, ref["ys"], ref["us"], ref["vs"], ref["ref_y"], ref["ref_u"],
        ref["ref_v"], QP, QPC, sr, LAM, subpel=subpel, deblock=deblock)


def _no_pyramid(*a, **kw):
    raise AssertionError("a band took the pyramid search")


@pytest.mark.parametrize("subpel,deblock,sr", CASES)
def test_pchunk_sharded_matches_vcp_tpu(reference, monkeypatch, subpel,
                                        deblock, sr):
    """Packed buffers and final recons equal vcp_tpu's sharded step; a
    band never takes the pyramid search, even at sr 12 with sub-pel."""
    monkeypatch.setattr(mops, "hier_search", _no_pyramid)
    res = _sharded(reference, subpel, deblock, sr)
    key = f"{subpel}_{int(deblock)}_{sr}"
    for name, got in zip(("packed", "ry", "ru", "rv"), res):
        np.testing.assert_array_equal(got.numpy(),
                                      reference[f"{name}_{key}"])
    assert res[0].dtype == torch.int16


@pytest.mark.parametrize("subpel,deblock", [(0, False), (1, True),
                                            (2, True)])
def test_pchunk_sharded_matches_one_device(reference, subpel, deblock):
    """At sr 4 the bands give the one-device ``encode_pchunk``'s bytes."""
    res = _sharded(reference, subpel, deblock, 4)
    for i in range(2):
        one = encode_pchunk(*(torch.from_numpy(reference[k][i]) for k in (
            "ys", "us", "vs", "ref_y", "ref_u", "ref_v")), QP, QPC, 4, LAM,
            deblock, subpel)
        for got, want in zip(res, one):
            assert torch.equal(got[i], want)


def test_iframe_batch_sharded_matches_vcp_tpu(reference):
    mesh = meshmod.make_mesh(devices=CPU8)
    got = meshmod.encode_iframe_batch_sharded(
        mesh, reference["iy"], reference["iu"], reference["iv"], QP, QPC)
    for g, name in zip(got, ("iry", "iru", "irv")):
        np.testing.assert_array_equal(g.numpy(), reference[name])


@pytest.mark.parametrize("label", sorted(EXEC_ARGS))
def test_mesh_mp4_matches_vcp_tpu(reference, tmp_path, monkeypatch, label):
    """The executor's MP4 with ``VCP_MESH=8`` (8 bands of the 8 MB rows)
    equals vcp_tpu's byte for byte: the speed shape, and the CAVLC medium
    shape (sr 12, half-pel, the I16-only RD IDR)."""
    args, env = EXEC_ARGS[label]
    monkeypatch.setattr(meshmod, "visible_devices", lambda dev: CPU8)
    monkeypatch.setattr(mops, "hier_search", _no_pyramid)
    monkeypatch.setenv("VCP_MESH", "8")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    meshes = []
    real = te.H264Encoder._encode_gop_mesh

    def spy(self, frames, mesh):
        meshes.append(mesh.shape)
        return real(self, frames, mesh)
    monkeypatch.setattr(te.H264Encoder, "_encode_gop_mesh", spy)
    out = str(tmp_path / "port.mp4")
    t_executor.execute(os.path.join(reference["dir"], "in.y4m"), out, args,
                       device="cpu")
    assert meshes and all(m == {"data": 1, "tile": 8} for m in meshes)
    with open(out, "rb") as a, open(os.path.join(
            reference["dir"], label + ".mp4"), "rb") as b:
        assert a.read() == b.read()


def _encoder(monkeypatch, n_visible: int, **kw):
    monkeypatch.setattr(meshmod, "visible_devices",
                        lambda dev: [torch.device(dev)] * n_visible)
    cfg = te.EncoderConfig(**{"width": 128, "height": 96, **kw})
    return te.H264Encoder(cfg, device="cpu")


@pytest.mark.parametrize("env,kw,n_visible,tiles", [
    ("0", {}, 8, None),                         # turned off
    ("8", {"bframes": 2}, 8, None),             # B pictures
    ("8", {"transform8": True}, 8, None),       # 8x8 transform
    ("8", {"parts": True}, 8, None),            # partitions
    ("8", {}, 8, 6),                            # 6 MB rows: 8 -> 6
    ("8", {"height": 1080, "width": 1920}, 8, 4),   # 68 rows: 8 -> 4
    ("8", {"height": 80}, 8, 5),                # 5 rows
    ("", {}, 8, None),                          # no auto mesh on the CPU
    ("2", {}, 1, None),                         # too few devices: no mesh
    ("3", {"height": 64}, 8, 2),                # 4 rows: 3 -> 2
])
def test_get_mesh_rules(monkeypatch, env, kw, n_visible, tiles):
    monkeypatch.setenv("VCP_MESH", env)
    mesh = _encoder(monkeypatch, n_visible, **kw)._get_mesh()
    if tiles is None:
        assert mesh is None
    else:
        assert mesh.shape == {"data": 1, "tile": tiles}
        assert all(d == torch.device("cpu") for d in mesh.flat)


def test_get_mesh_auto_on_cards(monkeypatch):
    """Without VCP_MESH an encoder on ``cuda`` with two visible cards
    spreads over both (no card is touched to build the mesh)."""
    monkeypatch.delenv("VCP_MESH", raising=False)
    enc = _encoder(monkeypatch, 1)
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    monkeypatch.setattr(meshmod, "visible_devices", lambda dev: cards)
    enc.device = torch.device("cuda", 0)
    assert enc._get_mesh().flat == cards


def test_make_mesh_factoring_and_errors():
    assert meshmod.make_mesh(devices=CPU8).shape == {"data": 2, "tile": 4}
    assert meshmod.make_mesh(6, devices=CPU8).shape == {"data": 2,
                                                         "tile": 3}
    assert meshmod.make_mesh(3, data=1, tile=3, devices=CPU8).shape == {
        "data": 1, "tile": 3}
    with pytest.raises(RuntimeError, match="9 devices requested"):
        meshmod.make_mesh(9, devices=CPU8)
    assert meshmod.visible_devices("cpu") == [torch.device("cpu")]


@pytest.mark.parametrize("shape,row0", [
    ((32, 64), 8),          # a band that does not start on an MB row
    ((32, 64), 48),         # a band that runs past the reference
    ((32, 48), 0),          # another width
    ((24, 64), 0),          # not whole MB rows
])
def test_motion_search_band_checks(shape, row0):
    ref = torch.zeros((64, 64), dtype=torch.int32)
    with pytest.raises(ValueError, match="band"):
        motion_search(torch.zeros(shape, dtype=torch.int32), ref, 4, 4,
                      row0=row0)


def test_band_search_equals_plain():
    """The wrapper's band form on the CPU is ``full_search`` and
    ``mc_luma`` with ``row0``."""
    rng = np.random.default_rng(5)
    ref = torch.from_numpy(rng.integers(0, 256, (64, 48)).astype(np.int32))
    cur = torch.roll(ref, (3, -2), (0, 1))[16:48].contiguous()
    mv, pred = motion_search(cur, ref, 4, 4, with_pred=True, row0=16)
    want, _ = mops.full_search(cur, ref, 4, 4, 16)
    assert torch.equal(mv, want)
    assert torch.equal(pred, mops.mc_luma(ref, want, 4, 16))
    assert (mv[1:-1, 1:-1] == torch.tensor([-3, 2])).all()


def _launch_calls_outside_device_guard(path: str) -> list[int]:
    """Lines of ``lib.vcp_*`` calls in ``path`` not inside a ``with
    torch.cuda.device(...)`` block."""
    tree = ast.parse(open(path).read())
    bad = []

    def walk(node, guarded):
        if isinstance(node, ast.With) and any(
                ast.unparse(it.context_expr).startswith("torch.cuda.device(")
                for it in node.items):
            guarded = True
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute) \
                and node.func.attr.startswith("vcp_") \
                and ast.unparse(node.func.value) == "lib" \
                and not node.func.attr.endswith("_plan") and not guarded:
            bad.append(node.lineno)
        for child in ast.iter_child_nodes(node):
            walk(child, guarded)
    walk(tree, False)
    return bad


def test_launches_select_the_tensors_device():
    """Every kernel launch of the wrappers is made with its tensors'
    device current, and the motion kernel's launch plan takes the SM
    count of that card from the wrapper, not from the current device."""
    pkg = os.path.join(REPO, "vcp_tpu_torch")
    for mod in ("motion_cuda.py", "deblock_cuda.py"):
        assert _launch_calls_outside_device_guard(
            os.path.join(pkg, "ops", mod)) == [], mod
    src = open(os.path.join(pkg, "csrc", "motion_search.cu")).read()
    assert "cudaGetDevice(" not in src
    assert "int nsm" in src
