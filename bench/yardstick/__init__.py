"""The benchmark's own code: what later changes to the program may not
move.  Traffic generation, the weights, the plain reference, the counts
of operations and bytes, the table of peaks, the reduction of a profiler
trace, and the comparison that decides ``correct``.

Nothing here imports the program at module level; ``drivers`` imports
``repro_torch`` inside the functions that run it.
"""
