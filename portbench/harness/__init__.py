"""The benchmark's general code: the loader, the set-up and window, the
work counts, the trace reader and the comparison helpers.  What belongs to
one configuration, cell, job or metric lives in a file of its own beside
this package."""
