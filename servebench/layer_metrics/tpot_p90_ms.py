"""tpot_p90_ms (server scheduler): the 90th percentile, over every request
that finished inside the window with two tokens or more, of (finish - first
token) / (tokens - 1): the pace of decode rows that long prompts' chunks
share the steps with."""

from servebench.stats import percentile


def read(run, name):
    return percentile([
        (r.req.finished_at - r.req.first_token_at) * 1e3 / (len(r.req.tokens) - 1)
        for r in run.recs
        if r.ok and len(r.req.tokens) > 1 and run.t_open <= r.req.finished_at < run.t_close
    ], 90)
