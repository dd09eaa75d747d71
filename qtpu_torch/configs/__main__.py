"""Preset selector CLI (port of `python -m qtpu.configs`).

Usage:
    python -m qtpu_torch.configs list
    python -m qtpu_torch.configs <preset-name> [--out config.json]
"""

import sys

from qtpu_torch.configs import list_presets, load_presets, setup_config


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    if argv[0] == "list":
        presets = load_presets()
        print("Available presets:")
        for name in list_presets():
            print(f"  {name}: {presets[name].get('description', '')}")
        return 0
    out = "config.json"
    if "--out" in argv:
        out = argv[argv.index("--out") + 1]
    try:
        setup_config(argv[0], out)
    except KeyError as e:
        print(e)
        return 1
    print(f"Wrote preset '{argv[0]}' to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
