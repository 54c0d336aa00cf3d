"""The emulated Scout cluster (numpy copies of the reference's modules)."""
