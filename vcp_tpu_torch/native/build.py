"""Build the host library: the CABAC and CAVLC slice writers and NAL
escaping of the encoder (``cabac.cpp``, ``entropy.cpp``), the encoder's
changed-tile pass of the delta upload (``tiles.cpp``) and the host
decoder's deblocking filter, CABAC slice parser and reconstruction
(``deblock.cpp``, ``h264parse.cpp``, ``h264recon.cpp``).

Generates ``tables_gen.h`` from the port's own tables (the CAVLC VLC
tables and CBP maps of ``codec.h264.tables``; the CABAC
context-init (m, n) pairs of ``codec.h264.cabac_tables``; the dequant
scales, scans, chroma QP map, quarter-pel case table and intra gather
tables of ``ops.transform``, ``ops.transform8``, ``ops.motion`` and
``codec.h264.decoder``; the deblock alpha / beta / tc0 tables of
``ops.deblock``) and compiles the sources with g++ into a shared library
keyed by a hash of its inputs. Plain C ABI, loaded via ctypes.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
SOURCES = ("cabac.cpp", "entropy.cpp", "tiles.cpp", "deblock.cpp",
           "h264parse.cpp", "h264recon.cpp")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")


def _vlc(code: str) -> str:
    return "{%d,%d}" % (len(code), int(code, 2) if code else 0)


def _vlc_rows(name: str, rows: list[list[str | None]], width: int) -> str:
    """A C table of VLC codes, ``rows`` x ``width``; a missing code is
    {0,0}."""
    cells = ["{" + ",".join(_vlc(c) if c is not None else "{0,0}"
                            for c in row + [None] * (width - len(row)))
             + "}" for row in rows]
    return (f"static const VLC {name}[{len(rows)}][{width}] = "
            "{" + ",".join(cells) + "};")


def cavlc_tables() -> list[str]:
    """The CAVLC writer's tables (``entropy.cpp``): coeff_token per nC
    class and for chroma DC, total_zeros for 4x4 blocks and chroma DC,
    run_before, and the inter / intra coded_block_pattern maps."""
    from ..codec.h264 import tables as T

    def ct(name, tab, max_tc):
        return _vlc_rows(name, [[tab.get((t1, tc)) for t1 in range(4)]
                                for tc in range(max_tc + 1)], 4)

    def by_count(tab, n, width):
        return [list(tab.get(k, [])) for k in range(n)], width

    lines = ["struct VLC { uint8_t len; uint16_t bits; };",
             ct("CT_NC0", T.COEFF_TOKEN_NC0, 16),
             ct("CT_NC2", T.COEFF_TOKEN_NC2, 16),
             ct("CT_NC4", T.COEFF_TOKEN_NC4, 16),
             ct("CT_CHROMA", T.COEFF_TOKEN_CHROMA_DC, 4),
             _vlc_rows("TZ_4x4", *by_count(T.TOTAL_ZEROS_4x4, 16, 16)),
             _vlc_rows("TZ_CHROMA", *by_count(T.TOTAL_ZEROS_CHROMA_DC, 4,
                                              4)),
             _vlc_rows("RUN_BEFORE", *by_count(T.RUN_BEFORE, 8, 15))]
    for name, tab in (("CBP_INTER_CODE", T.CBP_INTER_TO_CODE),
                      ("CBP_INTRA_CODE", T.CBP_INTRA_TO_CODE)):
        lines.append(f"static const uint8_t {name}[48] = {{"
                     + ",".join(str(tab[c]) for c in range(48)) + "};")
    return lines


def generate_tables_header() -> str:
    from ..codec.h264.cabac_tables import CTX_INIT_I, CTX_INIT_PB, N_CTX

    lines = [
        "// GENERATED by vcp_tpu_torch/native/build.py.",
        "#pragma once",
        "#include <cstdint>",
        *cavlc_tables(),
        f"#define VCP_N_CTX {N_CTX}",
    ]

    def ctab(name, tab):
        cells = ",".join("{%d,%d}" % (m, n) for m, n in tab)
        lines.append(
            f"static const int8_t {name}[{len(tab)}][2] = {{{cells}}};")

    ctab("CTX_INIT_I", CTX_INIT_I)
    for idc in range(3):
        ctab(f"CTX_INIT_P{idc}", CTX_INIT_PB[idc])

    # the decoder's reconstruction and deblock tables
    import numpy as np

    from ..codec.h264 import decoder
    from ..codec.h264.tables import ZIGZAG_4x4
    from ..ops import deblock
    from ..ops import transform as tf
    from ..ops import transform8 as t8
    from ..ops.motion import _QPEL_TABLE

    def flat(name, arr, ctype="int32_t"):
        a = np.asarray(arr).reshape(-1)
        lines.append(f"static const {ctype} {name}[{a.size}] = {{"
                     + ",".join(str(int(v)) for v in a) + "};")

    flat("VCP_V4", tf.V_TABLE)                  # (6, 4, 4)
    flat("VCP_V8", t8.V8_TABLE)                 # (6, 8, 8)
    flat("VCP_ZZ4", ZIGZAG_4x4)                 # 16
    flat("VCP_ZZ8", t8.ZIGZAG_8x8)              # 64
    flat("VCP_CHROMA_QP", tf.CHROMA_QP_FULL)    # 52
    flat("VCP_QPEL", _QPEL_TABLE)               # (16, 6)
    for ns, tabs in ((4, decoder._I4_TABS), (8, decoder._I8_TABS)):
        packed = np.stack([np.stack(tabs[m]) for m in range(3, 9)])
        flat(f"VCP_I{ns}_TABS", packed, "uint8_t")  # (6 modes, 3, ns, ns)
    flat("VCP_DB_ALPHA", deblock.ALPHA)         # 52
    flat("VCP_DB_BETA", deblock.BETA)           # 52
    flat("VCP_DB_TC0", deblock.TC0)             # (3, 52)
    return "\n".join(lines) + "\n"


def build() -> str:
    """Compile (if stale) and return the .so path; raises on failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    srcs = [os.path.join(_DIR, s) for s in SOURCES]
    header = generate_tables_header()
    h = hashlib.sha256((header + " ".join(CXX_FLAGS)).encode())
    for src in srcs:
        with open(src, "rb") as fh:
            h.update(fh.read())
    key = h.hexdigest()[:16]
    so_path = os.path.join(BUILD_DIR, f"libvcp_host_{key}.so")
    if os.path.exists(so_path):
        return so_path
    # header dir and output name unique per process and thread:
    # concurrent first uses (test workers, a consumer's worker threads)
    # never read or replace a file another build is writing
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as inc:
        with open(os.path.join(inc, "tables_gen.h"), "w") as fh:
            fh.write(header)
        tmp = f"{so_path}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = ["g++", *CXX_FLAGS, f"-I{inc}", *srcs, "-o", tmp]
        proc = subprocess.run(cmd, capture_output=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError("host entropy build failed:\n"
                           + proc.stderr.decode(errors="replace"))
    os.replace(tmp, so_path)
    return so_path
