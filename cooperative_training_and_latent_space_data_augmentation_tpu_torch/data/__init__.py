"""Datasets: synthetic phantoms made from a seed, and ACDC-layout volume
trees read from NIfTI or NRRD files."""
