"""Tokens served a second over the window: the prompt tokens of every
request whose prefill completed in the window (a token the prefix cache
served counts), plus every output token emitted in it."""


def read(w):
    prompt = sum(len(r.req.prompt) for r in w.records if w.inside(r.first))
    output = sum(s.sampled for s in w.steps)
    if not prompt + output:
        return None
    return (prompt + output) / w.seconds
