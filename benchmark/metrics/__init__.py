"""One reader per metric: ``read(run)`` gives the metric's value from a
``record.Run``, or None where the run holds nothing to read (the harness
then leaves the metric out of the result's line)."""
