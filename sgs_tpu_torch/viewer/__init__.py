"""The network viewer bridge of the port."""
