"""``launch.train --debug-mesh 2x4`` in fp32, for
``tests/test_torch_dist.py``: run as a script,

    PYTHONPATH=src python tests/_torch_fp32_debug_mesh.py OUT.json

``get_config`` is patched to the fp32 form of each config at the top
level, so the ranks ``--debug-mesh`` spawns (which import this script as
their main module) see it too.  Writes the one-device run's and the
mesh's step losses.  Imports only ``repro_torch``.
"""
import dataclasses
import json
import sys
import tempfile

import repro_torch.configs as configs

_get_config = configs.get_config


def _fp32(name, reduced=False):
    return dataclasses.replace(_get_config(name, reduced), dtype="float32")


configs.get_config = _fp32

ARGV = ["--arch", "crinn-policy-100m", "--reduced", "--steps", "4", "--seq",
        "64", "--global-batch", "4", "--device", "cpu"]

if __name__ == "__main__":
    from repro_torch.launch import train
    with tempfile.TemporaryDirectory() as tmp:
        one = train.main(ARGV + ["--ckpt-dir", f"{tmp}/one"])
        mesh = train.main(ARGV + ["--ckpt-dir", f"{tmp}/mesh",
                                  "--debug-mesh", "2x4"])
    with open(sys.argv[1], "w") as f:
        json.dump({"one": [r["loss"] for r in one],
                   "mesh": [r["loss"] for r in mesh]}, f)
