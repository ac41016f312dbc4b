"""Interactive configuration wizard — the INIBuilder TUI equivalent.

Counterpart of circuitscape_tpu/tui.py.  Parity reference:
src/INIBuilder/run.jl:1-189 (10-step terminal wizard building a config
dict, then either computing immediately or writing
the INI), src/INIBuilder/filepicker.jl (interactive file picker).

Pure-stdlib terminal prompts (numbered menus instead of arrow-key
RadioMenus, so it works in any terminal or piped input).
"""

from __future__ import annotations

import os

from .config import CSConfig, init_config, write_config

LOGO = r"""
   ____ _                _ _                            _____ ____  _   _
  / ___(_)_ __ ___ _   _(_) |_ ___  ___ __ _ _ __   ___|_   _|  _ \| | | |
 | |   | | '__/ __| | | | | __/ __|/ __/ _` | '_ \ / _ \ | | | |_) | | | |
 | |___| | | | (__| |_| | | |_\__ \ (_| (_| | |_) |  __/ | | |  __/| |_| |
  \____|_|_|  \___|\__,_|_|\__|___/\___\__,_| .__/ \___| |_| |_|    \___/
                                            |_|   GPU port (PyTorch/CUDA)
"""


def _menu(title, options, default=0, input_fn=input, print_fn=print):
    print_fn(f"\n{title}")
    for i, opt in enumerate(options):
        marker = "*" if i == default else " "
        print_fn(f"  {i + 1}.{marker} {opt}")
    while True:
        raw = input_fn(f"choice [1-{len(options)}, enter={default + 1}]: ").strip()
        if not raw:
            return default
        try:
            v = int(raw) - 1
            if 0 <= v < len(options):
                return v
        except ValueError:
            pass
        print_fn("  invalid choice")


def _filepicker(prompt, input_fn=input, print_fn=print, start_dir="."):
    """Interactive directory browser (src/INIBuilder/filepicker.jl
    parity, numbered menus instead of arrow keys): directories first,
    `1` always goes up, picking a file returns its path, and any typed
    path is accepted directly."""
    cur = os.path.abspath(start_dir)
    while True:
        try:
            entries = sorted(os.listdir(cur))
        except OSError as e:
            print_fn(f"  cannot list {cur}: {e}")
            parent = os.path.dirname(cur)
            if parent == cur:
                return _ask_path(prompt, input_fn, print_fn, browse=False)
            cur = parent
            continue
        dirs = [e for e in entries
                if os.path.isdir(os.path.join(cur, e))]
        files = [e for e in entries
                 if not os.path.isdir(os.path.join(cur, e))]
        opts = ["../"] + [d + "/" for d in dirs] + files
        print_fn(f"\n{prompt} — browsing {cur}")
        for i, o in enumerate(opts):
            print_fn(f"  {i + 1}. {o}")
        raw = input_fn("pick a number, or type a path: ").strip()
        if not raw:
            continue
        if raw.isdigit() and 1 <= int(raw) <= len(opts):
            k = int(raw) - 1
            if k == 0:
                cur = os.path.dirname(cur) or cur
            elif k <= len(dirs):
                cur = os.path.join(cur, dirs[k - 1])
            else:
                return os.path.join(cur, files[k - 1 - len(dirs)])
        else:
            p = os.path.expanduser(raw)
            if os.path.isdir(p):
                cur = os.path.abspath(p)
            elif os.path.exists(p):
                return p
            else:
                print_fn(f"  '{p}' does not exist")


def _ask_path(prompt, input_fn=input, print_fn=print, must_exist=True,
              browse=True):
    while True:
        p = input_fn(f"{prompt} (? to browse): ").strip()
        if browse and p == "?":
            return _filepicker(prompt, input_fn, print_fn)
        if not p:
            print_fn("  a path is required")
            continue
        p = os.path.expanduser(p)
        if must_exist and not os.path.exists(p):
            print_fn(f"  '{p}' does not exist")
            continue
        return p


def _yesno(prompt, default=False, input_fn=input, print_fn=print):
    d = "y" if default else "n"
    raw = input_fn(f"{prompt} [y/n, enter={d}]: ").strip().lower()
    if not raw:
        return default
    return raw.startswith("y")


def start(input_fn=input, print_fn=print, device=None):
    """Run the wizard; returns the job's result when it runs the job now
    (on `device`, default CUDA, as compute()), else the config dict.

    Mirrors the reference steps (src/INIBuilder/run.jl:153-189):
    data type -> scenario -> input files -> mode options -> output
    options -> solver -> run now or write the INI.
    """
    print_fn(LOGO)
    cfg = init_config()

    # Step 1: data type
    dt = _menu("Step 1: Choose your input data type",
               ["raster", "network"], 0, input_fn, print_fn)
    cfg["data_type"] = ["raster", "network"][dt]

    # Step 2: scenario
    if cfg["data_type"] == "raster":
        sc = _menu("Step 2: Choose a modeling mode",
                   ["pairwise", "advanced", "one-to-all", "all-to-one"],
                   0, input_fn, print_fn)
        cfg["scenario"] = ["pairwise", "advanced", "one-to-all",
                           "all-to-one"][sc]
    else:
        sc = _menu("Step 2: Choose a modeling mode",
                   ["pairwise", "advanced"], 0, input_fn, print_fn)
        cfg["scenario"] = ["pairwise", "advanced"][sc]

    # Step 3: habitat input
    cfg["habitat_file"] = _ask_path(
        "Step 3: Path to habitat (resistance/conductance) file",
        input_fn, print_fn)
    cfg["habitat_map_is_resistances"] = (
        "True" if _yesno("   Does it hold resistances (not conductances)?",
                         True, input_fn, print_fn) else "False")

    # Step 4: focal nodes or sources/grounds
    if cfg["scenario"] == "advanced":
        cfg["source_file"] = _ask_path("Step 4: Current source file",
                                       input_fn, print_fn)
        cfg["ground_file"] = _ask_path("        Ground file",
                                       input_fn, print_fn)
        cfg["ground_file_is_resistances"] = (
            "True" if _yesno("   Ground values are resistances?", True,
                             input_fn, print_fn) else "False")
    else:
        cfg["point_file"] = _ask_path("Step 4: Focal node location file",
                                      input_fn, print_fn)

    # Step 5: raster connection scheme
    if cfg["data_type"] == "raster":
        four = _menu("Step 5: Cell connection scheme",
                     ["8 neighbors", "4 neighbors"], 0, input_fn, print_fn)
        cfg["connect_four_neighbors_only"] = "True" if four == 1 else "False"
        avg = _menu("        Cell connection calculation",
                    ["average conductance", "average resistance"],
                    0, input_fn, print_fn)
        cfg["connect_using_avg_resistances"] = "True" if avg == 1 else "False"

        if _yesno("Step 6: Use short-circuit regions (polygons)?", False,
                  input_fn, print_fn):
            cfg["use_polygons"] = "True"
            cfg["polygon_file"] = _ask_path("        Polygon file",
                                            input_fn, print_fn)
        if _yesno("        Use a mask file?", False, input_fn, print_fn):
            cfg["use_mask"] = "True"
            cfg["mask_file"] = _ask_path("        Mask file",
                                         input_fn, print_fn)

    # Step 7: output options
    cfg["write_cur_maps"] = ("True" if _yesno(
        "Step 7: Write current maps?", False, input_fn, print_fn) else "False")
    cfg["write_volt_maps"] = ("True" if _yesno(
        "        Write voltage maps?", False, input_fn, print_fn) else "False")

    # Step 8: solver
    sv = _menu("Step 8: Choose a solver",
               ["cg+amg (GPU batched PCG + AMG)",
                "cholmod (native direct Cholesky)"], 0, input_fn, print_fn)
    cfg["solver"] = ["cg+amg", "cholmod"][sv]

    # Step 9: output file
    out = input_fn("Step 9: Output base name (e.g. out/run.out): ").strip()
    cfg["output_file"] = out or "cs.out"
    outdir = os.path.dirname(cfg["output_file"])
    if outdir and not os.path.isdir(outdir):
        os.makedirs(outdir, exist_ok=True)

    # Step 10: run or save
    action = _menu("Step 10: What now?",
                   ["run the job now", "write the .ini and exit"],
                   0, input_fn, print_fn)
    if action == 0:
        from .run import compute
        return compute(cfg, device=device)
    ini_path = cfg["output_file"].rsplit(".out", 1)[0] + ".ini"
    csconfig = CSConfig.from_dict(cfg)
    out_file = csconfig.output_file
    csconfig.output_file = ini_path
    write_config(csconfig)
    csconfig.output_file = out_file
    print_fn(f"Wrote {ini_path}")
    return cfg
