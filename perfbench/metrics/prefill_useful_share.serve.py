"""Share of the flash forward's prefill tokens that the requests needed,
over the window, in %: the prompt tokens prefilled (the benchmark's own
lengths less the one that goes through decode) over the query tokens the
flash forward was launched with in prefills (its shape counter, per
attention layer).  What is missing is the bucket padding."""


def read(obs: dict):
    shapes = obs.get("flash_shapes")
    if not shapes:
        return None
    # (b, s, t, h, kv, hd, causal, window): prefills have s > 1
    launched = sum(n * key[0] * key[1] for key, n in shapes.items()
                   if key[1] > 1)
    if not launched:
        return None
    return 100.0 * obs["prompt_tokens_needed"] * obs["attention_layers"] \
        / launched
