"""Entry drivers: each builds the program for a cell and drives it."""
