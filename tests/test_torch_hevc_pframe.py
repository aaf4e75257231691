"""The HEVC P frame of vcp_tpu_torch (``frame_ops.encode_pframe``: full-pel
search, half / quarter-pel refinement, MC, residual, deblock) and its
pieces, and a P frame seeded through ``state.from_reference`` from the
JAX encoder's recon, against vcp_tpu on the CPU: exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcp_tpu.codec.h265 import encoder as jenc
from vcp_tpu.codec.h265 import frame_ops as jfo
from vcp_tpu.ops import transform_hevc as jth
from vcp_tpu_torch import state
from vcp_tpu_torch.codec.h265 import encoder as tenc
from vcp_tpu_torch.codec.h265 import frame_ops as tfo

from test_torch_gop import reference_tables
from video_util import synth_video

H, W = 64, 128


def _t(a):
    return torch.from_numpy(np.array(a, np.int32))


def _pad(frame):
    return tuple(np.pad(p, ((0, (-p.shape[0]) % m), (0, (-p.shape[1]) % m)),
                        mode="edge").astype(np.int32)
                 for p, m in zip(frame, (32, 16, 16)))


@pytest.fixture(scope="module")
def frames():
    """Moving synthetic frames (CTU multiples: no padding)."""
    return [_pad(f) for f in synth_video(W, H, 4)]


@pytest.fixture(scope="module")
def reference(frames):
    """A deblocked IDR recon of vcp_tpu's as the P frames' reference."""
    qp = 28
    out = jfo.encode_iframe(*(jnp.asarray(p) for p in frames[0]), qp,
                            jth.chroma_qp(qp))
    return tuple(np.asarray(out[k]) for k in ("recon_y", "recon_u",
                                               "recon_v"))


@pytest.mark.parametrize("qp,sr,subpel", [(21, 8, True), (28, 12, True),
                                          (10, 16, True), (34, 4, False)])
def test_pframe(frames, reference, qp, sr, subpel):
    cur = frames[2]
    lam = max(1, (qp - 12) // 3)
    qpc = jth.chroma_qp(qp)
    ref = jfo.encode_pframe(*(jnp.asarray(p) for p in (*cur, *reference)),
                            qp, qpc, sr, lam, subpel=subpel)
    out = tfo.encode_pframe(*(_t(p) for p in (*cur, *reference)), qp, qpc,
                            sr, lam, subpel=subpel)
    assert set(out) == set(ref)
    for k, a in ref.items():
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(a),
                                      err_msg=k)
    assert (np.asarray(ref["mv"]) != 0).any()


@pytest.mark.parametrize("flat", [False, True])
def test_fullpel_search_and_refinement(frames, reference, flat):
    """The batched search keeps vcp_tpu's first minimum in offset order
    (a flat picture ties everywhere), and the refinement its strict-<
    order over the eight neighbours."""
    cur = frames[1][0].copy()
    ref = reference[0].copy()
    if flat:
        cur[:] = 90
        ref[:] = 90
    sr, lam, pad = 6, 3, 10
    mv = tfo.search_fullpel(_t(cur), _t(ref), sr, lam)
    mv_j = np.asarray(jfo._search_fullpel(jnp.asarray(cur), jnp.asarray(ref),
                                          sr, lam))
    np.testing.assert_array_equal(mv.numpy(), mv_j)
    planes = tfo.luma_frac_planes(_t(ref), pad)
    planes_j = jfo._luma_frac_planes(jnp.asarray(ref), pad)
    for (fy, fx), p in planes_j.items():
        np.testing.assert_array_equal(planes[4 * fy + fx].numpy(),
                                      np.asarray(p))
    mvq = tfo.refine_subpel(_t(cur), planes, mv, pad, lam)
    mvq_j = jfo._refine_subpel(jnp.asarray(cur), planes_j, jnp.asarray(mv_j),
                               pad, lam)
    np.testing.assert_array_equal(mvq.numpy(), np.asarray(mvq_j))


def test_pframe_seeded_from_the_reference_state(frames):
    """vcp_tpu's encoder codes IDR + P; its recon, GOP QP and POC seed the
    port's encoder through state.from_reference, which then codes the
    next P frame to the same NAL unit as vcp_tpu's."""
    kw = dict(width=W, height=H, qp=30, gop_size=8, effort=5)
    jx = jenc.HevcEncoder(jenc.HevcEncoderConfig(**kw))
    for f in frames[:2]:
        jx.encode_frame(*f)
    recon = tuple(np.asarray(p) for p in jx._recon)
    st = state.from_reference(reference_tables(), recon, jx._gop_qp,
                              device="cpu", codec="h265", poc=jx.poc)
    assert isinstance(st, state.HevcState) and st.poc == 2
    tx = tenc.HevcEncoder(tenc.HevcEncoderConfig(**kw), device="cpu")
    tx.resume(st)
    assert tx.encode_frame(*frames[2]) == jx.encode_frame(*frames[2])

