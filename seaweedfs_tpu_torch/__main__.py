"""`python -m seaweedfs_tpu_torch <command>`: the local volume commands, the
servers (`version`, `master`, `volume`, `server`), the operator `shell`,
and the cluster clients `benchmark`, `upload` and `download`."""

from __future__ import annotations

import argparse
import sys

from seaweedfs_tpu_torch.command import commands


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="seaweedfs_tpu_torch",
        description="SeaweedFS-class volumes and erasure coding on PyTorch and CUDA",
    )
    sub = parser.add_subparsers(dest="command", metavar="command")
    for cmd in commands().values():
        p = sub.add_parser(cmd.name, help=cmd.help)
        cmd.configure(p)
        p.set_defaults(_run=cmd.run)
    args = parser.parse_args(argv)
    if not getattr(args, "_run", None):
        parser.print_help()
        return 2
    try:
        return args._run(args)
    except (OSError, ValueError, KeyError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
