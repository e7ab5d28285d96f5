"""Physics operators (the reference's L2/L3 layers, vectorized for XLA)."""
