"""The cooperative predictor (the serving path of the solver)."""
