"""
Device kernels (JAX/XLA) for the segmentation engine.

Each module here replaces one of the reference's numba kernels
(reference: pyshepseg/shepseg.py, see SURVEY.md section 2.3) with a
data-parallel, statically-shaped formulation suitable for XLA compilation:

- :mod:`.shifts` — masked neighbour-shift utilities (halo-style access)
- :mod:`.clump` — connected-component labelling by iterative min-label
  propagation with pointer jumping (replaces the flood-fill ``clump``)
- :mod:`.segreduce` — segment histograms / spectral sums / relabelling
  (replaces ``makeSegSize`` / ``buildSegmentSpectra`` / ``relabelSegments``)
- :mod:`.elim_single` — single-pixel elimination sweeps
  (replaces ``mergeSinglePixels`` / ``findNearestNeighbourPixel``)
- :mod:`.elim_small` — the iterative small-segment elimination loop
  (replaces ``eliminateSmallSegments`` / ``findMergeSegment`` / ``doMerge``)
- :mod:`.kmeans` — Lloyd's k-means as matrix products (replaces sklearn KMeans)
"""
