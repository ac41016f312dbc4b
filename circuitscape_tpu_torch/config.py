"""Typed configuration system: INI parser, defaults, round-trip writer.

Parity reference: src/config.jl (CSConfig struct :7-53, parsers :55-135,
string converters :137-226, parse_config :228-242, init_config :245-300,
write_config :308-366).  Unknown INI keys are tolerated: they land in the
raw dict and are dropped at struct construction, matching the reference.
"""

from __future__ import annotations

import dataclasses
import logging
from . import consts


# Enum values are plain strings for ergonomic JSON/dict round-trips.
DT_RASTER = "raster"
DT_NETWORK = "network"

SC_PAIRWISE = "pairwise"
SC_ADVANCED = "advanced"
SC_ONETOALL = "one-to-all"
SC_ALLTOONE = "all-to-one"

ST_CG_AMG = "cg+amg"
ST_CHOLMOD = "cholmod"
ST_PARDISO = "mklpardiso"
ST_ACCELERATE = "accelerate"

PR_SINGLE = "single"
PR_DOUBLE = "double"

RP_KEEPALL = "keepall"
RP_RMVSRC = "rmvsrc"
RP_RMVGND = "rmvgnd"
RP_RMVALL = "rmvall"


def _parse_bool(d, key, default="false"):
    return d.get(key, default) in consts.TRUELIST


def _parse_data_type(s):
    return DT_RASTER if s in consts.RASTER else DT_NETWORK


def _parse_scenario(s):
    if s in consts.PAIRWISE:
        return SC_PAIRWISE
    if s in consts.ADVANCED:
        return SC_ADVANCED
    if s in consts.ONETOALL:
        return SC_ONETOALL
    if s in consts.ALLTOONE:
        return SC_ALLTOONE
    return SC_PAIRWISE


def _parse_solver(s):
    if s in consts.AMG:
        return ST_CG_AMG
    if s in consts.CHOLMOD:
        return ST_CHOLMOD
    if s in consts.PARDISO:
        return ST_PARDISO
    if s in consts.ACCELERATE:
        return ST_ACCELERATE
    # registered extension tiers keep their name (solve/dispatch.py
    # registry — the plugin surface); unknown spellings fall back to the
    # default like the reference (src/config.jl:109-119)
    try:
        from .solve.dispatch import _SOLVER_REGISTRY
        if str(s).lower() in _SOLVER_REGISTRY:
            return str(s).lower()
    except Exception:
        pass
    return ST_CG_AMG


def _parse_precision(s):
    return PR_SINGLE if s in consts.SINGLE else PR_DOUBLE


def _parse_log_level(s):
    return logging.DEBUG if s in consts.DEBUG else logging.INFO


def _parse_remove_policy(s):
    return s if s in (RP_RMVSRC, RP_RMVGND, RP_RMVALL) else RP_KEEPALL


@dataclasses.dataclass
class CSConfig:
    """Mirror of the reference CSConfig (src/config.jl:7-53)."""

    version: str = "unknown"
    data_type: str = DT_RASTER
    scenario: str = SC_PAIRWISE
    habitat_file: str = ""
    habitat_map_is_resistances: bool = True
    connect_four_neighbors_only: bool = False
    connect_using_avg_resistances: bool = False
    use_polygons: bool = False
    polygon_file: str = ""
    source_file: str = ""
    ground_file: str = ""
    ground_file_is_resistances: bool = True
    use_unit_currents: bool = False
    use_direct_grounds: bool = False
    remove_src_or_gnd: str = RP_KEEPALL
    use_mask: bool = False
    mask_file: str = ""
    solver: str = ST_CG_AMG
    parallelize: bool = False
    # Circuitscape-4 key, tolerated by the reference's INI parser; here
    # a value > 0 additionally caps the device batch width (solves per
    # chunk) — the batched analogue of "number of parallel workers"
    max_parallel: int = 0
    precision: str = PR_DOUBLE
    use_64bit_indexing: bool = True
    cholmod_batch_size: int = 1000
    low_memory_mode: bool = False
    preemptive_memory_release: bool = False
    use_variable_source_strengths: bool = False
    variable_source_file: str = ""
    use_included_pairs: bool = False
    included_pairs_file: str = ""
    point_file: str = ""
    use_reclass_table: bool = False
    reclass_file: str = ""
    output_file: str = ""
    write_cur_maps: bool = False
    write_volt_maps: bool = False
    write_cum_cur_map_only: bool = False
    write_max_cur_maps: bool = False
    set_null_currents_to_nodata: bool = False
    set_null_voltages_to_nodata: bool = False
    set_focal_node_currents_to_zero: bool = False
    compress_grids: bool = False
    log_transform_maps: bool = False
    write_as_tif: bool = False
    log_file: str = ""
    log_level: int = logging.INFO
    suppress_messages: bool = False
    # circuitscape_tpu extension: periodic checkpoint/resume for long
    # pairwise jobs (empty = disabled)
    checkpoint_file: str = ""


    @classmethod
    def from_dict(cls, d: dict) -> "CSConfig":
        """Construct from a raw string dict (src/config.jl:87-135).

        Unknown keys in `d` are silently dropped, as in the reference.
        """
        g = d.get
        log_file = g("log_file", "None")
        return cls(
            version=g("version", "unknown"),
            data_type=_parse_data_type(g("data_type", "raster")),
            scenario=_parse_scenario(g("scenario", "not entered")),
            habitat_file=g("habitat_file", ""),
            habitat_map_is_resistances=_parse_bool(d, "habitat_map_is_resistances", "True"),
            connect_four_neighbors_only=_parse_bool(d, "connect_four_neighbors_only"),
            connect_using_avg_resistances=_parse_bool(d, "connect_using_avg_resistances"),
            use_polygons=_parse_bool(d, "use_polygons"),
            polygon_file=g("polygon_file", ""),
            source_file=g("source_file", ""),
            ground_file=g("ground_file", ""),
            ground_file_is_resistances=_parse_bool(d, "ground_file_is_resistances", "True"),
            use_unit_currents=_parse_bool(d, "use_unit_currents"),
            use_direct_grounds=_parse_bool(d, "use_direct_grounds"),
            remove_src_or_gnd=_parse_remove_policy(g("remove_src_or_gnd", "keepall")),
            use_mask=_parse_bool(d, "use_mask"),
            mask_file=g("mask_file", ""),
            solver=_parse_solver(g("solver", "cg+amg")),
            parallelize=_parse_bool(d, "parallelize"),
            max_parallel=int(float(g("max_parallel", "0") or 0)),
            precision=_parse_precision(g("precision", "Double")),
            use_64bit_indexing=_parse_bool(d, "use_64bit_indexing", "true"),
            cholmod_batch_size=int(g("cholmod_batch_size", "1000")),
            low_memory_mode=_parse_bool(d, "low_memory_mode"),
            preemptive_memory_release=_parse_bool(d, "preemptive_memory_release"),
            use_variable_source_strengths=_parse_bool(d, "use_variable_source_strengths"),
            variable_source_file=g("variable_source_file", ""),
            use_included_pairs=_parse_bool(d, "use_included_pairs"),
            included_pairs_file=g("included_pairs_file", ""),
            point_file=g("point_file", ""),
            use_reclass_table=_parse_bool(d, "use_reclass_table"),
            reclass_file=g("reclass_file", ""),
            output_file=g("output_file", ""),
            write_cur_maps=_parse_bool(d, "write_cur_maps"),
            write_volt_maps=_parse_bool(d, "write_volt_maps"),
            write_cum_cur_map_only=_parse_bool(d, "write_cum_cur_map_only"),
            write_max_cur_maps=_parse_bool(d, "write_max_cur_maps"),
            set_null_currents_to_nodata=_parse_bool(d, "set_null_currents_to_nodata"),
            set_null_voltages_to_nodata=_parse_bool(d, "set_null_voltages_to_nodata"),
            set_focal_node_currents_to_zero=_parse_bool(d, "set_focal_node_currents_to_zero"),
            compress_grids=_parse_bool(d, "compress_grids"),
            log_transform_maps=_parse_bool(d, "log_transform_maps"),
            write_as_tif=_parse_bool(d, "write_as_tif"),
            log_file="" if log_file == "None" else log_file,
            log_level=_parse_log_level(g("log_level", "INFO")),
            suppress_messages=_parse_bool(d, "suppress_messages"),
            checkpoint_file=(lambda v: "" if v == "None" else v)(
                g("checkpoint_file", "None")),
        )

    def to_dict(self) -> dict:
        """String-dict round trip (src/config.jl:178-226)."""
        b = lambda v: "True" if v else "False"
        return {
            "version": self.version,
            "data_type": self.data_type,
            "scenario": self.scenario,
            "habitat_file": self.habitat_file,
            "habitat_map_is_resistances": b(self.habitat_map_is_resistances),
            "connect_four_neighbors_only": b(self.connect_four_neighbors_only),
            "connect_using_avg_resistances": b(self.connect_using_avg_resistances),
            "use_polygons": b(self.use_polygons),
            "polygon_file": self.polygon_file,
            "source_file": self.source_file,
            "ground_file": self.ground_file,
            "ground_file_is_resistances": b(self.ground_file_is_resistances),
            "use_unit_currents": b(self.use_unit_currents),
            "use_direct_grounds": b(self.use_direct_grounds),
            "remove_src_or_gnd": self.remove_src_or_gnd,
            "use_mask": b(self.use_mask),
            "mask_file": self.mask_file,
            "solver": self.solver,
            "parallelize": b(self.parallelize),
            "max_parallel": str(self.max_parallel),
            "precision": self.precision,
            "use_64bit_indexing": b(self.use_64bit_indexing),
            "cholmod_batch_size": str(self.cholmod_batch_size),
            "low_memory_mode": b(self.low_memory_mode),
            "preemptive_memory_release": b(self.preemptive_memory_release),
            "use_variable_source_strengths": b(self.use_variable_source_strengths),
            "variable_source_file": self.variable_source_file,
            "use_included_pairs": b(self.use_included_pairs),
            "included_pairs_file": self.included_pairs_file,
            "point_file": self.point_file,
            "use_reclass_table": b(self.use_reclass_table),
            "reclass_file": self.reclass_file,
            "output_file": self.output_file,
            "write_cur_maps": b(self.write_cur_maps),
            "write_volt_maps": b(self.write_volt_maps),
            "write_cum_cur_map_only": b(self.write_cum_cur_map_only),
            "write_max_cur_maps": b(self.write_max_cur_maps),
            "set_null_currents_to_nodata": b(self.set_null_currents_to_nodata),
            "set_null_voltages_to_nodata": b(self.set_null_voltages_to_nodata),
            "set_focal_node_currents_to_zero": b(self.set_focal_node_currents_to_zero),
            "compress_grids": b(self.compress_grids),
            "log_transform_maps": b(self.log_transform_maps),
            "write_as_tif": b(self.write_as_tif),
            "log_file": self.log_file if self.log_file else "None",
            "log_level": "DEBUG" if self.log_level == logging.DEBUG else "INFO",
            "suppress_messages": b(self.suppress_messages),
            "checkpoint_file": self.checkpoint_file if self.checkpoint_file
                               else "None",
        }


def init_config() -> dict:
    """Default raw config dict (src/config.jl:245-300).

    Includes the historical keys CSConfig does not read
    (print_timings, screenprint_log, profiler_log_file, ...).
    """
    return {
        "version": "unknown",
        "connect_four_neighbors_only": "False",
        "connect_using_avg_resistances": "False",
        "use_polygons": "False",
        "polygon_file": "(Browse for a short-circuit region file)",
        "source_file": "(Browse for a current source file)",
        "ground_file": "(Browse for a ground point file)",
        "ground_file_is_resistances": "True",
        "use_unit_currents": "False",
        "use_direct_grounds": "False",
        "remove_src_or_gnd": "keepall",
        "mask_file": "None",
        "use_mask": "False",
        "preemptive_memory_release": "False",
        "low_memory_mode": "False",
        "parallelize": "False",
        "print_timings": "False",
        "print_rusages": "False",
        "solver": "cg+amg",
        "use_variable_source_strengths": "False",
        "variable_source_file": "None",
        "set_null_currents_to_nodata": "False",
        "output_file": "(Choose a base name for output files)",
        "write_cum_cur_map_only": "False",
        "log_transform_maps": "False",
        "write_max_cur_maps": "False",
        "compress_grids": "False",
        "set_null_voltages_to_nodata": "False",
        "set_focal_node_currents_to_zero": "False",
        "write_volt_maps": "False",
        "write_cur_maps": "False",
        "habitat_map_is_resistances": "True",
        "habitat_file": "(Browse for a resistance file)",
        "scenario": "not entered",
        "data_type": "raster",
        "use_included_pairs": "False",
        "included_pairs_file": "(Browse for a file with pairs to include or exclude)",
        "point_file": "(Browse for file with locations of focal points or regions)",
        "use_reclass_table": "False",
        "reclass_file": "(Browse for file with reclassification data)",
        "profiler_log_file": "None",
        "log_file": "None",
        "log_level": "INFO",
        "screenprint_log": "False",
        "precision": "Double",
        "cholmod_batch_size": "1000",
        "use_64bit_indexing": "true",
        "write_as_tif": "false",
        "suppress_messages": "false",
    }


def parse_config(path: str) -> CSConfig:
    """Parse an INI file into a CSConfig (src/config.jl:228-242).

    Section headers ([...]) are skipped; every `key = value` line is kept,
    including keys CSConfig later drops.
    """
    cf = init_config()
    with open(path, "r") as f:
        for line in f:
            if not line:
                continue
            if line[0] == "[":
                continue
            idx = line.find("=")
            if idx < 0:
                continue
            var = line[:idx].rstrip()
            val = line[idx + 1:].strip()
            cf[var] = val
    return CSConfig.from_dict(cf)


def update(cfg: dict, new: dict) -> None:
    cfg.update(new)


def write_config(cfg: CSConfig) -> None:
    """Dump the effective config next to the outputs (src/config.jl:308-366).

    Written to cfg.output_file for reproducibility, mirroring the
    reference's section layout and Python-style booleans.
    """
    b = lambda v: "true" if v else "false"
    text = f"""[Circuitscape Mode]
data_type = {cfg.data_type}
scenario = {cfg.scenario}

[Version]
version = 5.0.0

[Habitat raster or graph]
habitat_file = {cfg.habitat_file}
habitat_map_is_resistances = {b(cfg.habitat_map_is_resistances)}

[Connection Scheme for raster habitat data]
connect_four_neighbors_only = {b(cfg.connect_four_neighbors_only)}
connect_using_avg_resistances = {b(cfg.connect_using_avg_resistances)}

[Short circuit regions (aka polygons)]
use_polygons = {b(cfg.use_polygons)}
polygon_file = {cfg.polygon_file}

[Options for advanced mode]
ground_file_is_resistances = {b(cfg.ground_file_is_resistances)}
source_file = {cfg.source_file}
remove_src_or_gnd = {cfg.remove_src_or_gnd}
ground_file = {cfg.ground_file}
use_unit_currents = {b(cfg.use_unit_currents)}
use_direct_grounds = {b(cfg.use_direct_grounds)}

[Mask file]
use_mask = {b(cfg.use_mask)}
mask_file = {cfg.mask_file}

[Options for one-to-all and all-to-one modes]
use_variable_source_strengths = {b(cfg.use_variable_source_strengths)}
variable_source_file = {cfg.variable_source_file}

[Options for pairwise and one-to-all and all-to-one modes]
included_pairs_file = {cfg.included_pairs_file}
use_included_pairs = {b(cfg.use_included_pairs)}
point_file = {cfg.point_file}

[Calculation options]
solver = {cfg.solver}

[Output options]
write_cum_cur_map_only = {b(cfg.write_cum_cur_map_only)}
log_transform_maps = {b(cfg.log_transform_maps)}
output_file = {cfg.output_file}
write_max_cur_maps = {b(cfg.write_max_cur_maps)}
write_volt_maps = {b(cfg.write_volt_maps)}
set_null_currents_to_nodata = {b(cfg.set_null_currents_to_nodata)}
set_null_voltages_to_nodata = {b(cfg.set_null_voltages_to_nodata)}
compress_grids = {b(cfg.compress_grids)}
write_cur_maps = {b(cfg.write_cur_maps)}
"""
    with open(cfg.output_file, "w") as f:
        f.write(text)
