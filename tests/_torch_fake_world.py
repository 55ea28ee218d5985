"""The fake-world side of ``tests/test_torch_dryrun.py``: a process of its
own (the default process group belongs to the whole process), run as

    PYTHONPATH=src python tests/_torch_fake_world.py OUT.json

It imports only ``repro_torch``.  On a fake 2x4 world it costs reduced
configs through the dry-run's own passes at small input shapes and writes,
per case, the depth-extrapolated and the full-depth counts, and the
counted collective bytes beside gather-on-use's closed form.
"""
from __future__ import annotations

import dataclasses
import json
import sys

from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_debug_mesh

#: (arch, layers, shape, fsdp, microbatch): a prefix and MoE with shared
#: experts, a period of two, MoE alone (its combine not recomputed), an
#: untied frontend, a recurrent state
CASES = [
    ("deepseek-moe-16b", 4, InputShape("t", "train", 32, 8), False, 1),
    ("deepseek-moe-16b", 4, InputShape("t", "train", 32, 8), False, 2),
    ("deepseek-moe-16b", 4, InputShape("p", "prefill", 32, 4), False, 1),
    ("deepseek-moe-16b", 4, InputShape("d", "decode", 64, 4), False, 1),
    ("gemma2-27b", 6, InputShape("t", "train", 32, 8), False, 1),
    ("gemma2-27b", 6, InputShape("t", "train", 32, 8), True, 1),
    ("gemma2-27b", 6, InputShape("d", "decode", 64, 2), False, 1),
    ("dbrx-132b", 3, InputShape("t", "train", 32, 8), False, 1),
    ("musicgen-medium", 3, InputShape("t", "train", 32, 8), False, 1),
    ("rwkv6-1.6b", 3, InputShape("d", "decode", 64, 4), False, 1),
]


def main(out: str) -> None:
    dryrun.fake_world(8)
    mesh = make_debug_mesh(2, 4)
    sizes = {"data": 2, "model": 4}
    rt = dryrun._runtime(mesh, dryrun.COSTING_OVERRIDES)
    res = []
    for arch, layers, shape, fsdp, mb in CASES:
        cfg = dataclasses.replace(get_config(arch, reduced=True),
                                  num_layers=layers)
        period, P = len(cfg.layer_pattern()), cfg.num_periods()
        kw = dict(fsdp=fsdp, quant_opt=False, microbatch=mb)
        depth = [dryrun._cost(dataclasses.replace(
            cfg, num_layers=cfg.first_k_dense + k * period), shape, mesh,
            rt, **kw) for k in (1, 2)]
        full = dryrun._cost(cfg, shape, mesh, rt, **kw)
        res.append({
            "case": f"{arch}-{layers}-{shape.kind}-fsdp{int(fsdp)}-mb{mb}",
            "extrap": {k: dryrun._extrap(depth[0][k], depth[1][k], P)
                       for k in ("flops", "bytes")},
            "extrap_coll": dryrun._extrap(depth[0]["coll"]["total_bytes"],
                                          depth[1]["coll"]["total_bytes"], P),
            "full": {k: full[k] for k in ("flops", "bytes")},
            "full_coll": full["coll"]["total_bytes"],
            "closed_form": dryrun.gather_on_use_bytes(
                cfg, shape, sizes, fsdp=fsdp, microbatch=mb),
        })
    with open(out, "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    main(sys.argv[1])
