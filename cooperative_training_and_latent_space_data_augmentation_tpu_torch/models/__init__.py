"""Eval-mode building blocks, encoders and decoders of the FTN and STN (NCHW)."""
