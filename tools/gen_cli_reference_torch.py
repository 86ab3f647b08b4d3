"""Render docs/reference.md from cutadapt_tpu_torch's CLI option table.

The port's counterpart of tools/gen_cli_reference.py: the same renderer
over ``cutadapt_tpu_torch.cli._OPTION_GROUPS`` and the port's
``__version__``. The port's option table is the JAX package's, so the
same document comes out:

    python tools/gen_cli_reference_torch.py | diff - docs/reference.md

tests/test_torch_bench.py checks that it equals the committed file.
Options the CLI help suppresses are documented in their own section.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from argparse import SUPPRESS  # noqa: E402

from cutadapt_tpu_torch.cli import _OPTION_GROUPS  # noqa: E402
from cutadapt_tpu_torch import __version__  # noqa: E402

# Help text for options whose --help entry is suppressed (matching the
# reference, which hides them from --help but documents some in its
# user guide / man page).
_HIDDEN_HELP = {
    "--profile": "Profile the run with cProfile; prints the top entries "
    "to stderr at exit.",
    "--gc-content": "Expected GC content of the input as a percentage, "
    "used by the k-mer heuristic. Default: 50.",
    "--buffer-size": "Reader chunk size in bytes for multi-core host "
    "processing. Default: 4000000.",
    "--no-index": "Disable the multi-adapter index optimization for "
    "anchored 5'/3' adapter sets.",
    "--shard": "Process shard INDEX of COUNT of the input "
    "(record-aligned byte range computed internally) and write a "
    "mergeable statistics pickle. See docs/multihost.md.",
    "--xopen-rxtx": None,  # not ours; placeholder if table grows
}


def _flags_text(flags, kwargs):
    metavar = kwargs.get("metavar")
    if metavar is None and "default" in kwargs and kwargs.get("action") not in (
        "store_true", "store_false", "count", "append_const", "store_const",
    ):
        dest = kwargs.get("dest") or flags[-1].lstrip("-").replace("-", "_")
        metavar = dest.upper()
    parts = []
    for f in flags:
        if metavar and kwargs.get("action") in (None, "append", "store"):
            parts.append(f"{f} {metavar}")
        else:
            parts.append(f)
    return ", ".join(parts)


def _help_text(flags, kwargs):
    h = kwargs.get("help")
    if h is SUPPRESS or h is None:
        for f in flags:
            if f in _HIDDEN_HELP and _HIDDEN_HELP[f]:
                return _HIDDEN_HELP[f], True
        return None, True
    default = kwargs.get("default")
    if "%(default)s" in h:
        h = h.replace("%(default)s", str(default))
    return h, False


def main():
    out = []
    out.append(f"# CLI reference (cutadapt-tpu {__version__})")
    out.append("")
    out.append(
        "<!-- GENERATED FILE — do not edit. Regenerate with:\n"
        "     python tools/gen_cli_reference.py > docs/reference.md -->"
    )
    out.append("")
    out.append(
        "The option surface matches the reference cutadapt CLI "
        "(same flags, same help text, same semantics; reference "
        "cli.py:~140-580). This file is rendered from the option "
        "table in `cutadapt_tpu/cli.py`."
    )
    out.append("")
    out.append("Usage: `cutadapt-tpu [options] -o OUTPUT INPUT` "
               "(or `python -m cutadapt_tpu ...`).")
    hidden = []
    for title, desc, options in _OPTION_GROUPS:
        out.append("")
        out.append(f"## {title}")
        out.append("")
        if desc:
            out.append(desc)
            out.append("")
        for flags, kwargs in options:
            text, was_hidden = _help_text(flags, kwargs)
            if was_hidden:
                if text:
                    hidden.append((flags, kwargs, text))
                continue
            out.append(f"- `{_flags_text(flags, kwargs)}` — {text}")
    if hidden:
        out.append("")
        out.append("## Hidden options")
        out.append("")
        out.append(
            "Not shown by `--help` (matching the reference CLI, which "
            "also suppresses them), but fully supported:"
        )
        out.append("")
        for flags, kwargs, text in hidden:
            out.append(f"- `{_flags_text(flags, kwargs)}` — {text}")
    out.append("")
    out.append("## Environment variables")
    out.append("")
    out.append(
        "The TPU engine's runtime knobs are environment variables, "
        "documented in [docs/tpu.md](tpu.md) (single host) and "
        "[docs/multihost.md](multihost.md) (multi-host)."
    )
    out.append("")
    print("\n".join(out))


if __name__ == "__main__":
    main()
