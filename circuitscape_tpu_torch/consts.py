"""Constants: accepted enum spellings, file-type magic, tolerances, sentinels.

Parity reference: src/consts.jl:1-45 in Circuitscape.jl.
"""

# Accepted spellings per enum (src/consts.jl:3-16)
RASTER = ("raster", "Raster")
PAIRWISE = ("pairwise", "Pairwise")
ADVANCED = ("advanced", "Advanced")
ONETOALL = ("one-to-all", "one_to_all")
ALLTOONE = ("all-to-one", "all_to_one")
SINGLE = ("single", "Single")
DOUBLE = ("double", "Double")

# Solver spellings (src/consts.jl:11-14).  The tiers keep the historical
# names so existing .ini files run unchanged:
#   cg+amg  -> batched stencil PCG + geometric multigrid on the GPU (the
#              stencil path), or, off it, ELL PCG with the SA-AMG V-cycle
#              on the job's device (solve/cg.py, solve/amg.py)
#   cholmod -> the native sparse Cholesky on the host (solve/native_chol.py)
AMG = ("cg+amg", "amg+cg")
CHOLMOD = ("cholmod", "cholesky", "cholfact")
PARDISO = ("mklpardiso", "MKLPardiso", "PARDISO", "pardiso")
ACCELERATE = ("accelerate", "Accelerate", "ACCELERATE", "apple_accelerate")

TRUELIST = ("True", "true", "1")

# File types (src/consts.jl:24-29)
FILE_TYPE_NPY = 1
FILE_TYPE_AAGRID = 2
FILE_TYPE_TXTLIST = 3
FILE_TYPE_INCL_PAIRS_AAGRID = 4
FILE_TYPE_INCL_PAIRS = 5
FILE_TYPE_GEOTIFF = 6

# File header magic (src/consts.jl:31-35)
FILE_HDR_GZIP = b"\x1f\x8b\x08"
FILE_HDR_NPY = "\x93NUMPY"
FILE_HDR_AAGRID = "ncols"
FILE_HDR_INCL_PAIRS_AAGRID = "min"
FILE_HDR_INCL_PAIRS = "mode"

# Logging level spellings (src/consts.jl:38)
DEBUG = ("DEBUG", "debug", "Debug")

# Norm-check tolerances (src/consts.jl:41-42)
TOL_SINGLE = 1e-3
TOL_DOUBLE = 1e-5

# Sentinel for invalid/unreachable resistance entries in shortcut mode
# (src/consts.jl:45)
RESISTANCE_INVALID = -777

# Universal nodata normalization value (src/io.jl:546)
NODATA = -9999.0

# CG solver settings (src/core.jl:639-642)
CG_RTOL = 1e-6
CG_ITMAX = 100_000
RESIDUAL_GATE = 1e-4

# Branch currents below this fraction of the max are zeroed (src/out.jl:283-287)
BRANCH_CURRENT_CUTOFF = 1e-8

# Output text filter for near-zero branch currents (src/out.jl:119-121)
OUTPUT_ATOL = 1e-6
