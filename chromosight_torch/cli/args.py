"""Small command-line grammar engine, drop-in for the docopt dependency.

Parses the same grammar as the reference CLI (``cli/chromosight.py:8-151``)
and produces the same args dictionary shape: subcommand names map to
booleans, ``<positional>`` keys to strings, ``--option`` keys to values or
booleans.  Short aliases and ``--opt=value`` / ``--opt value`` forms are
both accepted.

The port's copy of ``chromosight_tpu/cli/args.py``, unchanged.
"""

from __future__ import annotations

import sys


class CliError(SystemExit):
    pass


# option spec: long name -> (short alias or None, takes_value, default)
COMMON_OPTS = {
    "--help": ("-h", False, False),
    "--version": (None, False, False),
    "--verbose": (None, False, False),
}

SUBCOMMANDS = {
    "detect": {
        "positionals": ["<contact_map>", "<prefix>"],
        "options": {
            "--kernel-config": ("-k", True, None),
            "--pattern": ("-P", True, "loops"),
            "--pearson": ("-p", True, "auto"),
            "--win-size": ("-W", True, "auto"),
            "--iterations": ("-i", True, "1"),
            "--win-fmt": ("-w", True, "json"),
            "--norm": ("-n", True, "auto"),
            "--subsample": ("-s", True, "no"),
            "--inter": ("-I", False, False),
            "--tsvd": ("-V", False, False),
            "--smooth-trend": ("-T", False, False),
            "--n-mads": ("-N", True, "5"),
            "--min-dist": ("-m", True, "auto"),
            "--max-dist": ("-M", True, "auto"),
            "--no-plotting": (None, False, False),
            "--min-separation": ("-S", True, "auto"),
            "--dump": ("-d", True, None),
            "--threads": ("-t", True, "1"),
            "--perc-zero": ("-z", True, "auto"),
            "--perc-undetected": ("-u", True, "auto"),
        },
    },
    "generate-config": {
        "positionals": ["<prefix>"],
        "options": {
            "--preset": ("-e", True, "loops"),
            "--click": ("-c", True, None),
            "--norm": ("-n", True, "auto"),
            "--win-size": ("-W", True, "auto"),
            "--n-mads": ("-N", True, "5"),
            "--chroms": ("-C", True, None),
            "--inter": ("-I", False, False),
            "--threads": ("-t", True, "1"),
        },
    },
    "quantify": {
        "positionals": ["<bed2d>", "<contact_map>", "<prefix>"],
        "options": {
            "--inter": ("-I", False, False),
            "--pattern": ("-P", True, "loops"),
            "--subsample": ("-s", True, "no"),
            "--win-fmt": ("-w", True, "json"),
            "--kernel-config": ("-k", True, None),
            "--norm": ("-n", True, "auto"),
            "--threads": ("-t", True, "1"),
            "--n-mads": ("-N", True, "5"),
            "--win-size": ("-W", True, "auto"),
            "--perc-undetected": ("-u", True, "auto"),
            "--perc-zero": ("-z", True, "auto"),
            "--no-plotting": (None, False, False),
            "--tsvd": ("-V", False, False),
        },
    },
    "list-kernels": {
        "positionals": [],
        "options": {
            "--long": (None, False, False),
            "--mat": (None, False, False),
            "--name": (None, True, "all"),
        },
    },
    "test": {"positionals": [], "options": {}},
}


def _all_option_keys():
    keys = set()
    for sub in SUBCOMMANDS.values():
        keys.update(sub["options"])
    keys.update(COMMON_OPTS)
    return keys


def parse_args(argv, usage, version=None):
    """Parse argv (without program name) into a docopt-style dict."""
    args = {}
    # Initialise every key across all subcommands so downstream code can
    # read any option regardless of the active subcommand (docopt behaviour)
    for name, sub in SUBCOMMANDS.items():
        args[name] = False
        for pos in sub["positionals"]:
            args.setdefault(pos, None)
        for opt, (_, takes_value, default) in sub["options"].items():
            args.setdefault(opt, default)
    for opt, (_, takes_value, default) in COMMON_OPTS.items():
        args.setdefault(opt, default)

    if not argv or argv[0] in ("-h", "--help"):
        print(usage)
        raise CliError(0)
    if argv[0] == "--version":
        print(version or "")
        raise CliError(0)
    sub_name = argv[0]
    if sub_name not in SUBCOMMANDS:
        sys.stderr.write(usage + "\n")
        raise CliError(1)
    args[sub_name] = True
    sub = SUBCOMMANDS[sub_name]
    short_map = {
        short: long
        for long, (short, _, _) in {**sub["options"], **COMMON_OPTS}.items()
        if short
    }

    positionals = []
    i = 1
    while i < len(argv):
        tok = argv[i]
        if tok in ("-h", "--help"):
            print(usage)
            raise CliError(0)
        if tok == "--version":
            print(version or "")
            raise CliError(0)
        if tok.startswith("--"):
            if "=" in tok:
                key, val = tok.split("=", 1)
            else:
                key, val = tok, None
            spec = {**sub["options"], **COMMON_OPTS}.get(key)
            if spec is None:
                sys.stderr.write(f"Unknown option: {key}\n{usage}\n")
                raise CliError(1)
            _, takes_value, _ = spec
            if takes_value:
                if val is None:
                    i += 1
                    if i >= len(argv):
                        sys.stderr.write(f"{key} requires a value\n")
                        raise CliError(1)
                    val = argv[i]
                args[key] = val
            else:
                args[key] = True
        elif tok.startswith("-") and tok != "-":
            key = short_map.get(tok[:2])
            if key is None:
                sys.stderr.write(f"Unknown option: {tok}\n{usage}\n")
                raise CliError(1)
            _, takes_value, _ = {**sub["options"], **COMMON_OPTS}[key]
            if takes_value:
                if len(tok) > 2:
                    val = tok[2:].lstrip("=")
                else:
                    i += 1
                    if i >= len(argv):
                        sys.stderr.write(f"{key} requires a value\n")
                        raise CliError(1)
                    val = argv[i]
                args[key] = val
            else:
                args[key] = True
        else:
            positionals.append(tok)
        i += 1

    expected = sub["positionals"]
    if len(positionals) != len(expected):
        sys.stderr.write(usage + "\n")
        raise CliError(1)
    for name, val in zip(expected, positionals):
        args[name] = val
    return args
