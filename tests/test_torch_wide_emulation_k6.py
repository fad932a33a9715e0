"""K6 past d=512 on the CPU through ``tests/cuda_emu/emulate.py``:
``csrc/consensus_bwd_wide.cuh``'s design with K7 on the dS' it stores,
against the wrappers' plain versions on the same inputs; its workspace and
the refusals of bad arguments.

Limits as tests/test_torch_emulation_k2.py holds the narrow kernels:
||got - want|| <= rtol ||want|| and |got - want| <= rtol (min(1, max|want|)
+ |want|), rtol 1e-4 for float32 and 1e-2 for bfloat16 (one rounding); and
for float32 outputs, normwise within 1e-5 of the plain version.  The
fixtures and helpers are in ``tests/wide_emulation_common.py``.
"""

import ctypes
import numpy as np
import pytest
import torch
from glom_tpu_torch.kernels import consensus as consensus_kernel
from glom_tpu_torch.kernels import ff as ff_kernel
from glom_tpu_torch.kernels._common import DTYPE_CODES
from glom_tpu_torch.ops import consensus as plain_cons
from glom_tpu_torch.ops import feedforward as plain_ff
from glom_tpu_torch.ops.masks import local_consensus_mask
from tests.cuda_emu import emulate
from tests.wide_emulation_common import (  # noqa: F401 (fixtures)
    RTOL, _assert_close, _emulated_k67, _k67_inputs, k67)

torch.set_num_threads(1)


@pytest.mark.parametrize("n,L,d,dtype,extra", [
    (40, 2, 640, torch.float32, {}),              # a ragged query tile and key slab
    (40, 1, 640, torch.bfloat16, {"attend_self": True, "strided": True}),
    (36, 1, 1024, torch.float32, {"side": 6, "strided": True}),   # the locality mask, radius 1.5
    (70, 1, 640, torch.float32, {"attend_self": True}),   # two query and key tiles, 3 x 3 dS tiles
    (25, 1, 1024, torch.bfloat16, {}),
])
def test_emulated_wide_k6_hands_k7_its_ds(k67, n, L, d, dtype, extra):
    """The wide K6 (dKV, its key term also on its own, and the dS' it
    stores: every element, zero past n) and K7 on that dS' against their
    plain versions (K7 also against its plain twin on the same dS');
    without a dS' K6 gives the same dKV; two runs give the same bits."""
    extra = dict(extra)
    side, strided = extra.pop("side", None), extra.pop("strided", False)
    mask = torch.from_numpy(local_consensus_mask(side, 1.5)) if side else None
    kw = dict(non_local_mask=mask, **extra)
    levels, g, lse, delta = _k67_inputs(n, L, d, dtype, n + L + d, strided, **kw)
    dkv, ds, dq = _emulated_k67(k67, levels, g, lse, delta, mask, **extra)
    lf, gf = levels.float(), g.float()
    key_term, _ = plain_cons.consensus_dkv_terms(lf, gf, lse, delta, **kw)
    want = plain_cons.consensus_dkv(lf, gf, lse, delta, **kw)
    assert dkv.dtype == dtype and dq.dtype == dtype
    _assert_close(dkv, want, dtype)
    err = torch.linalg.vector_norm(dkv.float() - want)
    assert err <= RTOL[dtype] * torch.linalg.vector_norm(key_term) + (
        torch.finfo(dtype).eps / 2 * torch.linalg.vector_norm(want))
    assert not ds[..., n:].any()
    _assert_close(ds, plain_cons.consensus_ds(lf, gf, lse, delta, **kw), torch.float32)
    _assert_close(dq, plain_cons.consensus_dq(lf, gf, lse, delta, **kw), dtype)
    _assert_close(dq, plain_cons.consensus_dq_from_ds(levels, ds).float(), dtype)
    assert torch.equal(dkv, _emulated_k67(k67, levels, g, lse, delta, mask, keep_ds=False,
                                          **extra))
    again = _emulated_k67(k67, levels, g, lse, delta, mask, **extra)
    assert all(torch.equal(u, v) for u, v in zip((dkv, ds, dq), again))


def test_emulated_wide_k6_workspace_and_refusals(k67):
    """glom_consensus_bwd_workspace: none up to d=512, the wide design's
    parts above; bad arguments refused; the wide K6 refuses a call without
    its workspace or with one off a 16-byte boundary."""
    dkv_fn, dq_fn, ws_floats = k67
    assert ws_floats(2, 8, 3, 512, 0) == 0
    # S and dP (b, L, n, 32-padded n), P^T and (dS scale)^T (b, L, np, np),
    # key scales, V^T in f32 or bf16, dV and dK (b, L, n, d)
    pairs, n, np_, d = 6, 8, 32, 640
    f32 = 2 * pairs * n * np_ + 2 * pairs * np_ * np_ + pairs * np_ + pairs * d * np_ + (
        2 * pairs * n * d)
    assert ws_floats(2, 8, 3, 640, 0) == f32
    assert ws_floats(2, 8, 3, 640, 1) == f32 - pairs * d * np_ // 2
    for bad in ((2, 8, 3, 96, 0), (2, 8, 3, 640, 2), (0, 8, 3, 640, 0), (2, 0, 3, 640, 0)):
        assert ws_floats(*bad) < 0, bad
    levels, g, lse, delta = _k67_inputs(8, 1, 640, torch.float32, 0)
    out, ds = torch.empty(levels.shape), torch.zeros(consensus_kernel.ds_shape(levels))
    ws = torch.zeros(ws_floats(1, 8, 1, 640, 0) + 4)

    def k6(ws_ptr=ws.data_ptr(), d=640, width=640):
        return dkv_fn(levels.data_ptr(), *levels.stride()[:3], g.data_ptr(), lse.data_ptr(),
                      delta.data_ptr(), None, out.data_ptr(), ds.data_ptr(), ws_ptr, 1, 8, 1, d,
                      width, 0, 0, None)

    assert k6() == 0
    assert k6(ws_ptr=None) != 0                       # the wide design's workspace
    assert k6(ws_ptr=ws.data_ptr() + 4) != 0          # off a 16-byte boundary
    assert k6(d=96, width=96) != 0
    # a model 600 wide, zero-padded to 640, scales its logits by its own width
    assert k6(width=600) == 0 and k6(width=0) != 0 and k6(width=641) != 0
    assert dq_fn(levels.data_ptr(), *levels.stride()[:3], ds.data_ptr(), out.data_ptr(), 1, 8, 1,
                 640, 0, None) == 0                   # K7 takes the width as it is
