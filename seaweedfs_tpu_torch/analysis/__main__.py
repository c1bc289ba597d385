"""weedlint CLI — `python -m seaweedfs_tpu_torch.analysis`.

Exit code 0 when the tree is clean, 1 when any finding survives
suppression. Runs in tier-1 (tests/test_torch_weedlint.py); budgeted well
under 30 s.

  --strict        also flag unused suppression pragmas (the CI mode)
  --changed-only  per-file checkers only on files changed vs git HEAD
                  (project checkers still see the whole tree — their
                  invariants are global); the fast pre-commit mode
  --list-rules    print the rule catalog and exit
  --write-env-table [README.md]
                  regenerate the port's WEEDTPU_* env-var table between
                  its own weedlint-torch markers in the README (never the
                  JAX package's weedlint markers) from the registry
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

from seaweedfs_tpu_torch.analysis import PKG_ROOT, REPO_ROOT, RULES, run

#: the port's own markers in README.md, inside its section; the JAX
#: package's table sits between `weedlint:env-table` markers and is not
#: this registry's
ENV_TABLE_BEGIN = "<!-- weedlint-torch:env-table:begin -->"
ENV_TABLE_END = "<!-- weedlint-torch:env-table:end -->"


def changed_files() -> set[str]:
    """Absolute paths of .py files changed vs HEAD (staged, unstaged, and
    untracked)."""
    out: set[str] = set()
    for args in (
        ["git", "-C", REPO_ROOT, "diff", "--name-only", "HEAD"],
        ["git", "-C", REPO_ROOT, "ls-files", "--others", "--exclude-standard"],
    ):
        try:
            proc = subprocess.run(
                args, capture_output=True, text=True, timeout=20
            )
        except (OSError, subprocess.TimeoutExpired):
            continue
        for line in proc.stdout.splitlines():
            line = line.strip()
            if line.endswith(".py"):
                out.add(os.path.abspath(os.path.join(REPO_ROOT, line)))
    return out


def rewrite_env_table(readme_path: str) -> bool:
    from seaweedfs_tpu_torch.utils.config import env_table_markdown

    with open(readme_path, "r", encoding="utf-8") as f:
        text = f.read()
    begin = text.find(ENV_TABLE_BEGIN)
    end = text.find(ENV_TABLE_END)
    if begin < 0 or end < 0 or end < begin:
        print(
            f"{readme_path}: missing {ENV_TABLE_BEGIN} / {ENV_TABLE_END} "
            "markers",
            file=sys.stderr,
        )
        return False
    new = (
        text[: begin + len(ENV_TABLE_BEGIN)]
        + "\n"
        + env_table_markdown()
        + text[end:]
    )
    if new != text:
        with open(readme_path, "w", encoding="utf-8") as f:
            f.write(new)
    return True


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m seaweedfs_tpu_torch.analysis", description=__doc__
    )
    parser.add_argument("paths", nargs="*", help="files/dirs to scan (default: the package)")
    parser.add_argument("--strict", action="store_true")
    parser.add_argument("--changed-only", action="store_true")
    parser.add_argument("--list-rules", action="store_true")
    parser.add_argument(
        "--write-env-table", nargs="?", const=os.path.join(REPO_ROOT, "README.md"),
        metavar="README",
    )
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule in sorted(RULES):
            print(f"{rule:24s} {RULES[rule]}")
        return 0
    if args.write_env_table:
        return 0 if rewrite_env_table(args.write_env_table) else 1

    paths = None
    if args.paths:
        paths = []
        for p in args.paths:
            if os.path.isdir(p):
                from seaweedfs_tpu_torch.analysis import iter_source_files

                paths.extend(iter_source_files(p))
            else:
                paths.append(p)

    t0 = time.monotonic()
    findings = run(
        paths=paths,
        root=PKG_ROOT,
        strict=args.strict,
        changed_only_files=changed_files() if args.changed_only else None,
    )
    for f in findings:
        print(f.render())
    dt = time.monotonic() - t0
    print(
        f"weedlint: {len(findings)} finding(s) in {dt:.1f}s "
        f"({'strict' if args.strict else 'default'} mode)",
        file=sys.stderr,
    )
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
