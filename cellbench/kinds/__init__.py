"""The traffic kinds, each named by a traffic mix's "kind": each
has run(ctx, seed, seconds, trace, t_start)."""
