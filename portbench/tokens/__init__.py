"""Token laws, one file a law, found by the "token_law" of a traffic file
(spec.token_law; weights.Batches draws through it, uniform.py where the
file names none). Each defines draw(gen, shape, vocab, device): int64 ids
in [0, vocab) of `shape`, drawn from the torch.Generator `gen` on
`device` alone, so the same seed gives the same ids."""
