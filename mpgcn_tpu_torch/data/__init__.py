"""Datasets: synthetic generators, preprocessing, windows, support banks."""
