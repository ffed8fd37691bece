"""In-process restart ring of the port.  This slice ports only the
dispatch fingerprint (:mod:`.fingerprint`) that the collective wrapper
feeds; the wrapper, abort ladder and monitor process come with the
in-process slice."""
