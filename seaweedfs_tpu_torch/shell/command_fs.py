"""Filesystem shell commands — fs.ls / fs.cat / fs.mkdir / fs.rm /
fs.mv / fs.du / fs.meta.save / fs.meta.load, mirroring
weed/shell/command_fs_*.go; fs.meta.save/load are the metadata
export/import checkpoint mechanism.

The filer is discovered through the master's cluster-node list (filers
announce themselves with FilerHeartbeat).
"""

from __future__ import annotations

import json
import time
from typing import TextIO

from seaweedfs_tpu_torch.filer.entry import Entry
from seaweedfs_tpu_torch.shell import (
    CommandEnv,
    ShellCommand,
    ShellError,
    iter_entries,
    register,
)


def _split(args: list[str], bools: set[str] = frozenset(), valued: set[str] = frozenset()):
    """Split `-flag [value]` options from positional paths."""
    flags: dict[str, object] = {b: False for b in bools}
    flags.update({v: "" for v in valued})
    positional: list[str] = []
    it = iter(args)
    for tok in it:
        if not tok.startswith("-"):
            positional.append(tok)
            continue
        name, _, inline = tok.lstrip("-").partition("=")
        if name in bools:
            flags[name] = True
        elif name in valued:
            if inline:
                flags[name] = inline
            else:
                try:
                    flags[name] = next(it)
                except StopIteration:
                    raise ShellError(f"flag -{name} needs a value") from None
        else:
            raise ShellError(f"unknown flag -{name}")
    return flags, positional


def _positional(args: list[str]) -> list[str]:
    return _split(args)[1]


def _rp(env: CommandEnv, paths: list[str]) -> list[str]:
    """Resolve path args against the REPL working directory (fs.cd)."""
    return [env.resolve(p) for p in paths]


def do_fs_ls(args: list[str], env: CommandEnv, w: TextIO) -> None:
    flags, paths = _split(args, bools={"l"})
    paths = _rp(env, paths or ["."])
    fc = env.filer_client()
    for path in paths:
        entries = fc.list(path, limit=10000)
        for e in entries:
            if flags["l"]:
                kind = "d" if e.is_directory else "-"
                w.write(
                    f"{kind} {e.size:>12} "
                    f"{time.strftime('%Y-%m-%d %H:%M', time.localtime(e.attributes.mtime))} "
                    f"{e.name}\n"
                )
            else:
                w.write(e.name + ("/" if e.is_directory else "") + "\n")


register(
    ShellCommand(
        "fs.ls",
        "fs.ls [-l] [path ...]\n\tlist filer directory entries",
        do_fs_ls,
    )
)


def do_fs_cat(args: list[str], env: CommandEnv, w: TextIO) -> None:
    paths = _rp(env, _positional(args))
    if not paths:
        raise ShellError("fs.cat needs a path")
    fc = env.filer_client()
    for path in paths:
        data = fc.read_file(path)
        try:
            w.write(data.decode())
        except UnicodeDecodeError:
            w.write(f"<{len(data)} binary bytes>\n")


register(ShellCommand("fs.cat", "fs.cat <path ...>\n\tprint file contents", do_fs_cat))


def do_fs_mkdir(args: list[str], env: CommandEnv, w: TextIO) -> None:
    paths = _rp(env, _positional(args))
    if not paths:
        raise ShellError("fs.mkdir needs a path")
    fc = env.filer_client()
    for path in paths:
        fc.create(Entry(path=path, is_directory=True))
        w.write(f"created {path}\n")


register(ShellCommand("fs.mkdir", "fs.mkdir <path ...>\n\tcreate directories", do_fs_mkdir))


def do_fs_rm(args: list[str], env: CommandEnv, w: TextIO) -> None:
    flags, paths = _split(args, bools={"r"})
    paths = _rp(env, paths)
    if not paths:
        raise ShellError("fs.rm needs a path")
    fc = env.filer_client()
    for path in paths:
        fc.delete(path, recursive=bool(flags["r"]))
        w.write(f"removed {path}\n")


register(
    ShellCommand(
        "fs.rm", "fs.rm [-r] <path ...>\n\tdelete files/directories", do_fs_rm
    )
)


def do_fs_mv(args: list[str], env: CommandEnv, w: TextIO) -> None:
    paths = _rp(env, _positional(args))
    if len(paths) != 2:
        raise ShellError("fs.mv needs <src> <dst>")
    env.filer_client().rename(paths[0], paths[1])
    w.write(f"moved {paths[0]} -> {paths[1]}\n")


register(ShellCommand("fs.mv", "fs.mv <src> <dst>\n\tmove/rename an entry", do_fs_mv))


def do_fs_du(args: list[str], env: CommandEnv, w: TextIO) -> None:
    paths = _rp(env, _positional(args) or ["."])
    fc = env.filer_client()

    def walk(path: str) -> tuple[int, int]:
        files, size = 0, 0
        for e in iter_entries(fc, path):
            if e.is_directory:
                f2, s2 = walk(e.path)
                files += f2
                size += s2
            else:
                files += 1
                size += e.size
        return files, size

    for path in paths:
        files, size = walk(path)
        w.write(f"{path}: {files} files, {size} bytes\n")


register(ShellCommand("fs.du", "fs.du [path ...]\n\tdisk usage of a subtree", do_fs_du))


def do_fs_meta_save(args: list[str], env: CommandEnv, w: TextIO) -> None:
    """Export filer metadata (entries incl. chunk lists) as JSONL —
    the §5 checkpoint/backup mechanism (fs.meta.save analog)."""
    flags, roots = _split(args, valued={"o"})
    if not flags["o"]:
        raise ShellError("fs.meta.save needs -o <file>")
    roots = _rp(env, roots or ["."])
    fc = env.filer_client()
    count = 0
    with open(flags["o"], "w", encoding="utf-8") as f:

        def walk(path: str) -> None:
            nonlocal count
            for e in iter_entries(fc, path):
                f.write(json.dumps(e.to_dict()) + "\n")
                count += 1
                if e.is_directory:
                    walk(e.path)

        for r in roots:
            walk(r)
    w.write(f"saved {count} entries to {flags['o']}\n")


register(
    ShellCommand(
        "fs.meta.save",
        "fs.meta.save -o <file> [root ...]\n\texport filer metadata as JSONL",
        do_fs_meta_save,
    )
)


def do_fs_meta_load(args: list[str], env: CommandEnv, w: TextIO) -> None:
    """Import metadata saved by fs.meta.save. Entries point at the SAME
    chunk fids — a namespace restore, not a data copy (matching the
    reference's fs.meta.load)."""
    flags, _ = _split(args, valued={"i"})
    if not flags["i"]:
        raise ShellError("fs.meta.load needs -i <file>")
    fc = env.filer_client()
    count = 0
    with open(flags["i"], encoding="utf-8") as f:
        for lineno, line in enumerate(f, start=1):
            line = line.strip()
            if not line:
                continue
            try:
                d = json.loads(line)
            except ValueError:
                # a restore is not a crash-resume: a torn/corrupt dump line
                # must abort loudly, not be skipped — partial restores are
                # worse than failed ones
                raise ShellError(
                    f"corrupt dump line {lineno} in {flags['i']} — "
                    f"restore aborted after {count} entries"
                )
            fc.create(Entry.from_dict(d))
            count += 1
    w.write(f"loaded {count} entries from {flags['i']}\n")


register(
    ShellCommand(
        "fs.meta.load",
        "fs.meta.load -i <file>\n\trestore filer metadata from a fs.meta.save dump",
        do_fs_meta_load,
    )
)


def do_fs_tree(args: list[str], env: CommandEnv, w: TextIO) -> None:
    """Recursive tree view of the namespace (command_fs_tree.go analog)."""
    paths = _rp(env, _positional(args) or ["."])
    fc = env.filer_client()
    dirs = files = 0

    def walk(path: str, indent: str) -> None:
        nonlocal dirs, files
        for e in iter_entries(fc, path):
            w.write(f"{indent}{e.name}{'/' if e.is_directory else ''}\n")
            if e.is_directory:
                dirs += 1
                walk(e.path, indent + "  ")
            else:
                files += 1

    for p in paths:
        w.write(p + "\n")
        walk(p, "  ")
    w.write(f"{dirs} directories, {files} files\n")


register(
    ShellCommand(
        "fs.tree",
        "fs.tree [path ...]\n\trecursively print the namespace tree",
        do_fs_tree,
    )
)


def do_fs_meta_cat(args: list[str], env: CommandEnv, w: TextIO) -> None:
    """Print one entry's full metadata as JSON (fs.meta.cat analog) —
    chunk list, attributes, extended attrs."""
    paths = _rp(env, _positional(args))
    if not paths:
        raise ShellError("fs.meta.cat <path ...>")
    fc = env.filer_client()
    for path in paths:
        e = fc.lookup(path)
        if e is None:
            raise ShellError(f"{path} not found")
        w.write(json.dumps(e.to_dict(), indent=2, sort_keys=True) + "\n")


register(
    ShellCommand(
        "fs.meta.cat",
        "fs.meta.cat <path ...>\n\tprint an entry's metadata (chunks, attributes) as JSON",
        do_fs_meta_cat,
    )
)


def do_fs_configure(args: list[str], env: CommandEnv, w: TextIO) -> None:
    """Per-path storage rules (command_fs_configure.go analog): pin
    collection/replication/TTL/read-only to a namespace prefix. With no
    flags, prints the active rule set."""
    flags, _ = _split(
        args,
        bools={"readOnly", "delete", "apply"},
        valued={"locationPrefix", "collection", "replication", "ttl"},
    )
    fc = env.filer_client()
    if flags["locationPrefix"]:
        # resolve against the REPL cwd like every other fs.* path — a
        # relative prefix would store a rule that never matches anything
        pfx = env.resolve(str(flags["locationPrefix"]))
        if str(flags["locationPrefix"]).endswith("/") and not pfx.endswith("/"):
            pfx += "/"  # normpath strips the trailing slash prefixes rely on
        flags["locationPrefix"] = pfx
    if not flags["locationPrefix"]:
        rules = fc.get_filer_conf()
        if not rules:
            w.write("fs.configure: no rules\n")
        for r in rules:
            w.write(
                f"{r['location_prefix']}: collection={r.get('collection', '')!r} "
                f"replication={r.get('replication', '')!r} ttl={r.get('ttl', '')!r} "
                f"readOnly={bool(r.get('read_only'))}\n"
            )
        return
    if not flags["apply"]:
        verb = "delete rule for" if flags["delete"] else "set rule for"
        w.write(
            f"fs.configure (dry): would {verb} {flags['locationPrefix']} — "
            "re-run with -apply\n"
        )
        return
    rules = fc.set_filer_conf(
        flags["locationPrefix"],
        collection=str(flags["collection"]),
        replication=str(flags["replication"]),
        ttl=str(flags["ttl"]),
        read_only=bool(flags["readOnly"]),
        delete=bool(flags["delete"]),
    )
    w.write(f"fs.configure: {len(rules)} rules active\n")


register(
    ShellCommand(
        "fs.configure",
        "fs.configure [-locationPrefix /path/ [-collection c] [-replication xyz] "
        "[-ttl 7d] [-readOnly] [-delete] -apply]\n\tper-path storage rules; "
        "no flags prints the active rules",
        do_fs_configure,
    )
)


def do_fs_cd(args: list[str], env: CommandEnv, w: TextIO) -> None:
    """Change the REPL working directory (command_fs_cd.go analog);
    subsequent relative fs.* paths resolve against it."""
    paths = _positional(args)
    target = env.resolve(paths[0] if paths else "/")
    fc = env.filer_client()
    if target != "/":
        e = fc.lookup(target)
        if e is None or not e.is_directory:
            raise ShellError(f"{target} is not a directory")
    env.cwd = target
    w.write(f"cwd: {target}\n")


register(ShellCommand("fs.cd", "fs.cd [dir]\n\tchange the shell working directory", do_fs_cd))


def do_fs_pwd(args: list[str], env: CommandEnv, w: TextIO) -> None:
    w.write(env.cwd + "\n")


register(ShellCommand("fs.pwd", "fs.pwd\n\tprint the shell working directory", do_fs_pwd))
