"""repro_torch.core: MP-BCFW state, objective, steps and passes."""
