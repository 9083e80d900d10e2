"""Projection, binning, compositing and post-processing."""
