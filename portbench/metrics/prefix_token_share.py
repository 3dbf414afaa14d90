"""Prefix cache: prompt rows served from a registered prefix (the program's
BatcherMetrics.prefill_tokens_saved) over the prompt tokens admitted in the
window, %. Nothing to read where no prefix hit."""


def read(w):
    saved = w.counters["prefill_tokens_saved"]
    if not saved or not w.prompt_tokens:
        return None
    return 100.0 * saved / w.prompt_tokens
