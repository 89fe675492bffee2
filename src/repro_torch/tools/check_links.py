"""Check intra-repo markdown links (paths + heading anchors).

Port of ``repro/tools/check_links.py`` (standard library only; copied).

Usage:
    PYTHONPATH=src python -m repro_torch.tools.check_links README.md docs

Each argument is a markdown file or a directory (scanned for ``*.md``).
Every inline link or image target is resolved relative to the file that
contains it: external schemes (http/https/mailto) are skipped, relative
paths must exist inside the repository, and ``#fragment`` anchors must
match a heading of the target file under GitHub's slugification rules
(lowercase, punctuation stripped, spaces to hyphens).  Exits nonzero with
one line per broken link — the docs CI job runs this over ``docs/`` and
the README so cross-references cannot rot silently.
"""
from __future__ import annotations

import argparse
import re
import sys
from pathlib import Path

# inline links/images: [text](target) / ![alt](target); ignores ```code``` via
# a fence-stripping pre-pass rather than regex heroics
_LINK_RE = re.compile(r"!?\[[^\]]*\]\(([^)\s]+)(?:\s+\"[^\"]*\")?\)")
_HEADING_RE = re.compile(r"^#{1,6}\s+(.*)$", re.MULTILINE)
_EXTERNAL = ("http://", "https://", "mailto:", "ftp://")


def _strip_fences(text: str) -> str:
    """Drop fenced code blocks so example snippets don't register links."""
    out, fenced = [], False
    for line in text.splitlines():
        if line.lstrip().startswith("```"):
            fenced = not fenced
            continue
        if not fenced:
            out.append(line)
    return "\n".join(out)


def slugify(heading: str) -> str:
    """GitHub-style anchor slug of one heading line."""
    h = re.sub(r"[`*_]", "", heading.strip().lower())
    h = re.sub(r"[^\w\- ]", "", h)
    return re.sub(r" ", "-", h)


def heading_slugs(path: Path) -> set[str]:
    """All anchor slugs a markdown file exposes (with -1/-2 dedup suffixes)."""
    slugs: set[str] = set()
    counts: dict[str, int] = {}
    for m in _HEADING_RE.finditer(_strip_fences(path.read_text())):
        base = slugify(m.group(1))
        n = counts.get(base, 0)
        counts[base] = n + 1
        slugs.add(base if n == 0 else f"{base}-{n}")
    return slugs


def check_file(path: Path, repo_root: Path) -> list[str]:
    """Broken-link descriptions for one markdown file (empty when clean)."""
    errors: list[str] = []
    text = _strip_fences(path.read_text())
    for m in _LINK_RE.finditer(text):
        target = m.group(1)
        if target.startswith(_EXTERNAL) or target.startswith("<"):
            continue
        frag = ""
        if "#" in target:
            target, frag = target.split("#", 1)
        dest = path if not target else (path.parent / target).resolve()
        if not dest.exists():
            errors.append(f"{path}: broken link -> {m.group(1)}")
            continue
        try:  # links may not escape the repository
            dest.relative_to(repo_root)
        except ValueError:
            errors.append(f"{path}: link escapes repo -> {m.group(1)}")
            continue
        if frag:
            if dest.is_dir() or dest.suffix.lower() not in (".md", ".markdown"):
                errors.append(f"{path}: anchor on non-markdown -> {m.group(1)}")
            elif frag.lower() not in heading_slugs(dest):
                errors.append(f"{path}: missing anchor -> {m.group(1)}")
    return errors


def collect(args: list[str]) -> list[Path]:
    """Expand file/directory arguments into the markdown files to check."""
    files: list[Path] = []
    for a in args:
        p = Path(a)
        if p.is_dir():
            files.extend(sorted(p.glob("*.md")))
        elif p.exists():
            files.append(p)
        else:
            raise SystemExit(f"check_links: no such file or directory: {a}")
    return files


def main(argv: list[str] | None = None) -> int:
    """CLI entry point; returns the number of broken links."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("paths", nargs="+",
                    help="markdown files or directories of *.md")
    args = ap.parse_args(argv)
    repo_root = Path.cwd().resolve()
    errors: list[str] = []
    files = collect(args.paths)
    for f in files:
        errors.extend(check_file(f, repo_root))
    for e in errors:
        print(e, file=sys.stderr)
    print(f"check_links: {len(files)} file(s), {len(errors)} broken link(s)")
    return len(errors)


if __name__ == "__main__":
    raise SystemExit(min(main(), 1))
