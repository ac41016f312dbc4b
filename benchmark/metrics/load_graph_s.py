"""load_graph_s: host seconds a job spends reading its rasters and point
list and building its graph (CSTIMER "load raster data" + "construct
graph"), mean per job."""

from benchmark import frozen

SECTIONS = ("load raster data", "construct graph")


def read(run):
    return frozen.mean_sections(run.span_jobs, SECTIONS)
