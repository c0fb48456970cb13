"""The whole step's share of the cards' bf16 peak: tokens_per_s of the run
times the model FLOPs of a token (flops.flops_per_token, counted by the
model type's family: for gpt2 and mistral 6 x the matmul parameters plus
6 L T d for causal attention; recomputation not counted) over 989 TFLOP/s
a card, in %."""

def read(ctx):
    f = ctx["flops"]
    cell = ctx["cell"]
    peak, _ = f.peaks(ctx["device_name"])
    per_token = f.flops_per_token(cell.config, cell.traffic["block"])
    return 100.0 * ctx["e2e"]["tokens_per_s"] * per_token / (peak * cell.chips)
