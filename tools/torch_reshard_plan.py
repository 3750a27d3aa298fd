"""The bytes a reshard of the port's placed 4-stream SuBSENSE batch moves
rank to rank, from the metas alone (``parallel/placed.reshard_plan``), at
a given size, for each hop of ``chip_smoke.py``'s reshard chain (4 x 1 ->
2 x 2 -> 1 x 4 -> 4 x 1): the states as the chain reshards them, and a
chunk of frames placed on 4 x 1 as each call reshards it. No tensor is
made (``meta`` device), so it runs anywhere:

    python3 tools/torch_reshard_plan.py [--size 720x1280x3] [--chunk 3]
"""

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tracking_tpu_torch import get_algorithm  # noqa: E402
from tracking_tpu_torch.parallel.mesh import batch_dims  # noqa: E402
from tracking_tpu_torch.parallel.placed import (describe, map_tensors, plan_bytes, relaid, reshard_plan,  # noqa: E402
                                                tensor_bytes)
from tracking_tpu_torch.parallel.spatial import row_rule  # noqa: E402

STREAMS = 4
CHAIN = ((4, 1), (2, 2), (1, 4), (4, 1))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", default="720x1280x3", help="H x W x C of a frame")
    ap.add_argument("--chunk", type=int, default=3, help="frames a chunk")
    a = ap.parse_args(argv)
    h, w, c = (int(v) for v in a.size.split("x"))
    one = get_algorithm("subsense")().init(h, w, c, device="meta")
    states = map_tensors(lambda v: v.expand(STREAMS, *v.shape), one)
    total = tensor_bytes(states)
    frames = torch.empty((STREAMS, a.chunk, h, w, c), dtype=torch.uint8, device="meta")

    def rule(layout):
        stream, space = layout
        if space == 1:
            return lambda shape: ("stream",) + (None,) * (len(shape) - 1)
        return row_rule(h, batched=True)

    def axes(layout):
        return {"stream": layout[0], "space": layout[1]}

    print(f"SuBSENSE states of {STREAMS} streams at {h}x{w}x{c}: {total} bytes ({total / 2**20:.1f} MiB); "
          f"a chunk of {a.chunk} frames: {tensor_bytes(frames)} bytes")
    meta = describe(states, rule(CHAIN[0]), axes(CHAIN[0]))
    f_meta = describe(frames, batch_dims, axes(CHAIN[0]))
    for old, new in zip(CHAIN, CHAIN[1:]):
        new_meta = relaid(meta, rule(new), axes(new))
        moved = plan_bytes(reshard_plan(meta, axes(old), range(4), new_meta, axes(new), range(4)))
        f_new = relaid(f_meta, batch_dims, axes(new))
        f_moved = plan_bytes(reshard_plan(f_meta, axes(CHAIN[0]), range(4), f_new, axes(new), range(4)))
        print(f"{old[0]} x {old[1]} -> {new[0]} x {new[1]}: states {moved} bytes rank to rank "
              f"({moved / 2**20:.1f} MiB, {moved / total:.3f} of the states); the frames of a chunk placed on "
              f"{CHAIN[0][0]} x {CHAIN[0][1]}, on {new[0]} x {new[1]}: {f_moved} bytes")
        meta = new_meta
    print(f"a gather plus a new placement moves the states through the parent twice: {2 * total} bytes")


if __name__ == "__main__":
    main()
