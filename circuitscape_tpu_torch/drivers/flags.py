"""Per-run computation flags derived from the config.

Counterpart of circuitscape_tpu/drivers/flags.py.  Parity reference:
src/raster/pairwise.jl:1-12,32-52 (RasterFlags),
src/network/pairwise.jl:67-93 (NetworkFlags).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..out import OutputFlags, get_output_flags


@dataclass
class RasterFlags:
    is_raster: bool
    is_pairwise: bool
    is_advanced: bool
    is_onetoall: bool
    is_alltoone: bool
    grnd_file_is_res: bool
    policy: str
    four_neighbors: bool
    avg_res: bool
    outputflags: OutputFlags


@dataclass
class NetworkFlags:
    is_raster: bool
    is_advanced: bool
    is_alltoone: bool
    is_onetoall: bool
    grnd_file_is_res: bool
    policy: str
    outputflags: OutputFlags


def get_raster_flags(cfg) -> RasterFlags:
    return RasterFlags(
        is_raster=True,
        is_pairwise=cfg.scenario == "pairwise",
        is_advanced=cfg.scenario == "advanced",
        is_onetoall=cfg.scenario == "one-to-all",
        is_alltoone=cfg.scenario == "all-to-one",
        grnd_file_is_res=cfg.ground_file_is_resistances,
        policy=cfg.remove_src_or_gnd,
        four_neighbors=cfg.connect_four_neighbors_only,
        avg_res=cfg.connect_using_avg_resistances,
        outputflags=get_output_flags(cfg),
    )


def get_network_flags(cfg) -> NetworkFlags:
    return NetworkFlags(
        is_raster=False,
        is_advanced=cfg.scenario == "advanced",
        is_alltoone=False,
        is_onetoall=False,
        grnd_file_is_res=cfg.ground_file_is_resistances,
        policy=cfg.remove_src_or_gnd,
        outputflags=get_output_flags(cfg),
    )
