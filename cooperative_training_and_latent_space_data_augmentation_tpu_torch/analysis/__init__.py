"""Analysis and visualization of trained models (matplotlib is imported only
by the functions that draw)."""
