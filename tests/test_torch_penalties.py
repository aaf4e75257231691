"""The partition penalties ``VCP_P8_PENALTY``, ``VCP_P2_PENALTY`` and
``VCP_P8_MINSPLIT`` change the port's P step exactly as they change
vcp_tpu's: an ``h264-cpu``-like partitioned P frame (half-pel, 8x8
transform, intra overlay) under non-default values gives vcp_tpu's
decisions, levels, recon and NAL unit, and not those of the defaults.

vcp_tpu reads the three at import into module constants that its jitted
P step reads while tracing, so the test patches those constants and
encodes at a frame width no other test encodes (272), which makes a
fresh trace; the port reads the switches on every call."""

import numpy as np
import pytest
import torch

from test_torch_encoder_quality import moving_frames
from vcp_tpu.codec.h264 import headers as jh
from vcp_tpu.codec.h264 import pframe as jp
from vcp_tpu.codec.h264.frame_ops import pad_plane
from vcp_tpu_torch.codec.h264 import entropy as t_entropy
from vcp_tpu_torch.codec.h264 import headers as th
from vcp_tpu_torch.codec.h264 import pframe as tp

W, H = 272, 64
QP, SR = 25, 24
# fewer partitions than the defaults (40, 20, 4) allow
HIGH = {"VCP_P8_PENALTY": "400", "VCP_P2_PENALTY": "300",
        "VCP_P8_MINSPLIT": "64"}
CONSTS = {"VCP_P8_PENALTY": "P8X8_BIT_PENALTY",
          "VCP_P2_PENALTY": "P2PART_BIT_PENALTY",
          "VCP_P8_MINSPLIT": "P8X8_MIN_SPLIT_Q"}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _port_step(cur, ref):
    return tp.encode_pframe(*map(_t, cur + ref), QP, QP, SR, True, 1, True,
                            True, True)


@pytest.fixture(scope="module")
def steps():
    fr = moving_frames(4, w=W)
    cur, ref = ([pad_plane(p, 16 if k == 0 else 8)
                 for k, p in enumerate(fr[i])] for i in (3, 0))
    mp = pytest.MonkeyPatch()
    try:
        default = _port_step(cur, ref)
        for env, const in CONSTS.items():
            mp.setenv(env, HIGH[env])
            mp.setattr(jp, const, int(HIGH[env]))
        port = _port_step(cur, ref)
        j = jp._encode_pframe_device_parts(
            *cur, *ref, QP, QP, SR, jp.lam_for_qp(QP), True, 1, True, True)
    finally:
        mp.undo()
    return {k: np.asarray(v) for k, v in j.items()}, port, default


def test_penalties_read_per_call(monkeypatch):
    assert tp.part_penalties() == (40, 20, 4)
    for env, v in HIGH.items():
        monkeypatch.setenv(env, v)
    assert tp.part_penalties() == (400, 300, 64)


def test_step_matches_vcp_tpu(steps):
    j, t, default = steps
    assert set(j) == set(t)
    for k in j:
        np.testing.assert_array_equal(t[k].numpy().astype(np.int64),
                                      j[k].astype(np.int64), err_msg=k)
    # the switches moved the decision
    assert (t["parts"] > 0).sum() < (default["parts"] > 0).sum()


def _params(mod):
    sp = mod.SeqParams(width=W, height=H, profile_idc=100, poc_type=0,
                       num_ref_frames=2)
    return sp, mod.PicParams(init_qp=26, cabac=True, transform_8x8=True)


def test_nal_matches_vcp_tpu(steps):
    j, t, default = steps
    kw = dict(frame_num=1, qp=QP, deblock=True, poc_lsb=6)
    nals = []
    for d in (j, {k: v.numpy() for k, v in t.items()},
              {k: v.numpy() for k, v in default.items()}):
        data = {k: v for k, v in d.items() if not k.startswith("recon")}
        data["mv"] = data["mv8"][::2, ::2]
        nals.append(t_entropy.write_pslice(*_params(th), data=data, **kw))
    data = {k: v for k, v in j.items() if not k.startswith("recon")}
    data["mv"] = data["mv8"][::2, ::2]
    ref = jp.write_pslice(*_params(jh), data=data, cabac=True, **kw)
    assert nals[0] == nals[1] == ref
    assert nals[2] != ref
