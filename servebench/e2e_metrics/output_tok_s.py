"""output_tok_s: every token the server applied inside the window, over the
window's seconds."""


def read(run, name):
    tokens = sum(r.tokens_at("close") - r.tokens_at("open") for r in run.recs)
    return tokens / run.window_s
