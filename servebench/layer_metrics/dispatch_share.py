"""dispatch_share (step loop, ``runtime/server.py`` ``_step_serial``,
``obs/stepline.py``): the host's ``dispatch`` phase over the steps' wall,
summed over the window's step records, in percent."""


def read(run, name):
    recs = run.stepline
    wall = sum(r["wall_s"] for r in recs)
    if not wall:
        return None
    return 100.0 * sum(r["phases"].get("dispatch", 0.0) for r in recs) / wall
