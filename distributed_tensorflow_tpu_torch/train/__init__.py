"""Training loops of the port: the MLP ``Trainer`` with its eager,
scanned and whole-run paths."""
