"""The hand-written fused m-step D2Q9 LBM kernel and its wrappers."""
