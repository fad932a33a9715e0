"""Digests of every kernel's outputs on seeded inputs, for checking that a
change leaves a kernel's bits as they were: run it in two checkouts on the
same card and compare the lines.

Each kernel wrapper (K1-K4 and K6-K8, through their public entry points)
runs once per element type at the flagship shapes (d=512, b=8, n=256, six
levels) on inputs made from a seed on the host, and the tool prints one
JSON line ``{"digests": {"<kernel> <dtype>": "<sha256 of the outputs'
bytes>"}, "device": ...}``.

    python -m glom_tpu_torch.tools.kernel_digest
"""

from __future__ import annotations

import hashlib
import json
import sys

import numpy as np
import torch

from glom_tpu_torch.kernels import consensus as consensus_kernel
from glom_tpu_torch.kernels import ff as ff_kernel
from glom_tpu_torch.kernels import fused_update

DIM, BATCH, N, LEVELS = 512, 8, 256, 6   # the flagship's shapes


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def digests(device) -> dict:
    """``{"<kernel> <dtype>": sha256}`` of each kernel's outputs."""
    rng = np.random.default_rng(0)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))

    h = 4 * DIM

    def ff_params(g):
        return {"w1": t(g, DIM, h, scale=DIM ** -0.5), "b1": t(g, h, scale=0.1),
                "w2": t(g, h, DIM, scale=h ** -0.5), "b2": t(g, DIM, scale=0.1)}

    bu, td = ff_params(LEVELS), ff_params(LEVELS - 1)
    lwi = t(BATCH, N, LEVELS + 1, DIM)
    g = t(BATCH, N, LEVELS, DIM)
    pos = t(N, DIM)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        cast = lambda tree: {k: v.to(device, dtype) for k, v in tree.items()}
        p, q = cast(bu), cast(td)
        x = lwi.to(device, dtype)
        dout = g.to(device, dtype)
        levels_view = x[..., 1:, :]
        out[f"grouped_ff {name}"] = _digest(ff_kernel.grouped_ff(p, x[..., :-1, :]))
        dx, hidden = ff_kernel.grouped_ff_dx(p, x[..., :-1, :], dout, keep_hidden=True)
        out[f"grouped_ff_dx {name}"] = _digest(dx, *hidden)
        out[f"grouped_ff_dw {name}"] = _digest(
            *ff_kernel.grouped_ff_dw(p, x[..., :-1, :], dout, hidden))
        del hidden
        o, lse = consensus_kernel.consensus_attention(levels_view)
        out[f"consensus_attention {name}"] = _digest(o, lse)
        delta = (dout.float() * o.float()).sum(-1).permute(0, 2, 1).unsqueeze(-1).contiguous()
        dkv, ds = consensus_kernel.consensus_dkv(levels_view, dout, lse, delta, keep_ds=True)
        out[f"consensus_dkv {name}"] = _digest(dkv, ds)
        out[f"consensus_dq {name}"] = _digest(
            consensus_kernel.consensus_dq(levels_view, dout, lse, delta, ds=ds))
        out[f"fused_level_update {name}"] = _digest(fused_update.fused_level_update(
            p, q, levels_view, x[..., :1, :], pos.to(device, dtype)[None, :, None, :]))
    torch.cuda.synchronize(device)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_digest: no CUDA device; the kernels run only on a GPU", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    with torch.inference_mode():
        result = digests(device)
    print(json.dumps({"digests": result, "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
