"""Frozen copies of the data the cells are made from."""
