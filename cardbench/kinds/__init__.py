"""One module a kind of cell (a workload file's ``kind``)."""
