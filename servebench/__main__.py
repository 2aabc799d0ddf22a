import os
import time

T_START = time.perf_counter()  # set-up counts from here: before torch is imported

# one CPU thread for torch's and numpy's host-side operations: the server's
# step loop is one Python thread, and idle pool threads on the card's few,
# shared host cores only add to the jitter of a host-bound step
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

from servebench.run import main  # noqa: E402

raise SystemExit(main(t_start=T_START))
