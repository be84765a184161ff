"""The harness's own code: the files it finds by name, the profile reader,
the peaks, statistics and the result line."""
