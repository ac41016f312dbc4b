"""maps_s: seconds a job spends on current maps: the device's node
currents and their reduction, the copies to the host and the ASC writers
(CSTIMER "fetch maps", "node currents + reduce", "write maps", "write
cumulative current maps"), mean per job."""

from benchmark import frozen

SECTIONS = ("fetch maps", "node currents + reduce", "write maps",
            "write cumulative current maps")


def read(run):
    return frozen.mean_sections(run.span_jobs, SECTIONS)
