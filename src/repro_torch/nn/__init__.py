"""NN layers of the port's LM decode path (`core`, `attention`,
`transformer`)."""
