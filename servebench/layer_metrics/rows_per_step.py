"""rows_per_step (server scheduler, ``runtime/server.py``): tokens the
server applied per decode chunk it dispatched over the window, from its
``counters`` (``tokens_generated`` / ``chunks``)."""


def read(run, name):
    chunks = run.counters_close["chunks"] - run.counters_open["chunks"]
    tokens = run.counters_close["tokens_generated"] - run.counters_open["tokens_generated"]
    return tokens / chunks if chunks else None
