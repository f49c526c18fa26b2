"""Average the weights of several checkpoints into one (SWA-style).

Usage:
    python -m tpu_unet_torch.avg_checkpoints ckpts/checkpoint_epoch{3,4,5}.npz \
        -o ckpts/checkpoint_avg.npz

The output is a standard checkpoint, loadable by predict, serve and
evaluate, with the newest (last) input's ``mask_values`` and config and an
``averaged_from`` list. Semantics: ``checkpoint.average_checkpoints``.
"""

from __future__ import annotations

import argparse

from tpu_unet_torch.checkpoint import average_checkpoints


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("inputs", nargs="+", help="Checkpoints to average "
                   "(order them oldest to newest; metadata comes from the last)")
    p.add_argument("--output", "-o", required=True, help="Output checkpoint path")
    args = p.parse_args(argv)
    average_checkpoints(args.inputs, args.output)
    print(f"Averaged {len(args.inputs)} checkpoints -> {args.output}")


if __name__ == "__main__":
    main()
