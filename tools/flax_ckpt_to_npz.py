#!/usr/bin/env python
"""Flatten a resuneta_tpu checkpoint's model variables into an .npz that the
PyTorch port loads (resuneta_torch.train.checkpoint.restore_variables).

    python tools/flax_ckpt_to_npz.py --model_path results/best_model.ckpt \
        --out weights.npz

Runs on the JAX side (it imports resuneta_tpu and orbax); the port itself
never does.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_path", required=True,
                        help="orbax checkpoint directory of resuneta_tpu")
    parser.add_argument("--out", required=True, help="output .npz path")
    args = parser.parse_args(argv)

    from resuneta_tpu.train.checkpoint import restore_variables
    from resuneta_torch.convert import flatten

    flat = flatten(restore_variables(args.model_path))
    np.savez(args.out, **{k: np.asarray(v) for k, v in flat.items()})
    print(f"wrote {len(flat)} arrays to {args.out}")


if __name__ == "__main__":
    main()
