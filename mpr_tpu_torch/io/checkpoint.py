"""Tape checkpointing: persist compiled programs and fitted constants.

The reference's only persistence is shape serialization (`.frep`
archives, frontend/frep.py implements that format).  Checkpoints are the
training-side addition: a fitted tape — program + the optimized constant
vector — round-trips through a single `.npz`, so an optimization run can
resume or ship its result without recompiling the source tree.
"""

from __future__ import annotations

import json

import numpy as np

from ..tape.tape import Tape


def save_tape(path: str, tape: Tape, imms=None) -> None:
    """Write a tape (optionally with updated constants) to ``path``."""
    imms = tape.imms if imms is None else np.asarray(imms, np.float32)
    if imms.shape[0] > tape.length:      # fitted TapeData imms are padded
        imms = imms[:tape.length]
    np.savez(path, ops=tape.ops, outs=tape.outs, lhss=tape.lhss,
             rhss=tape.rhss, imms=imms,
             params=np.frombuffer(
                 json.dumps(tape.params).encode(), np.uint8),
             meta=np.asarray([*tape.axis_slots, tape.result_slot,
                              tape.num_slots, tape.num_choices], np.int32))


def load_tape(path: str) -> Tape:
    with np.load(path) as z:
        m = z["meta"]
        params = {}
        if "params" in z.files:          # absent in pre-var checkpoints
            params = json.loads(bytes(z["params"]).decode())
        return Tape(ops=z["ops"], outs=z["outs"], lhss=z["lhss"],
                    rhss=z["rhss"], imms=z["imms"],
                    axis_slots=(int(m[0]), int(m[1]), int(m[2])),
                    result_slot=int(m[3]), num_slots=int(m[4]),
                    num_choices=int(m[5]), params=params)
