"""Word arithmetic, ring tables, NTT and RNS conversion on int64 tensors."""
