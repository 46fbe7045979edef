"""mfu.train (train step: ``train/steps.py``, ``optim/adamw.py``): PaLM's
model flops (6 N_active + 12 L H Q T a token, no credit for recompute)
of the window's steps over the window, as a share of the bf16 peak."""
from benchlib.flops import train_flops_per_token


def read(ctx):
    r = ctx.train
    if r is None or not r.step_ends:
        return None
    per_tok = train_flops_per_token(ctx.sizes, r.seq_len)
    window = r.step_ends[-1] - r.t_open
    return 100.0 * len(r.step_ends) * r.tokens_per_step * per_tok \
        / window / ctx.peaks["bf16_flops"]
