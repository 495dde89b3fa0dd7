"""Frozen operation and byte counts, one file per kernel family, the model
FLOPs of a round and the table of peaks: the yardstick of the rooflines."""
