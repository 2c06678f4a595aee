"""Several devices in one process (``sharded``) and several processes
(``multihost``)."""
