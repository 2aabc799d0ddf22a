"""queue_wait_p90_ms (server scheduler): the 90th percentile, over every
request admitted inside the window, of its admission stamp
(``Request.started_at``) less the time it fell due."""

from servebench.stats import percentile


def read(run, name):
    return percentile([
        (r.req.started_at - r.due) * 1e3 for r in run.recs
        if r.req.started_at is not None and run.t_open <= r.req.started_at < run.t_close
    ], 90)
