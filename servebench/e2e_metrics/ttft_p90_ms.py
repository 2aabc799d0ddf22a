"""ttft_p90_ms: the 90th percentile, over every request whose first token
was applied inside the window, of that token's stamp less the time the
request fell due (an open loop's schedule, a closed loop's send)."""

from servebench.stats import percentile


def read(run, name):
    return percentile([
        (r.req.first_token_at - r.due) * 1e3 for r in run.recs
        if r.req.first_token_at is not None and run.t_open <= r.req.first_token_at < run.t_close
    ], 90)
