"""Float64 reference chains other than reference.py's nearest-neighbour XXZ
chain: one module per chain, found by the configuration's model.chain
(harness.chain). A module's `Chain(model, device)` takes the
configuration's "model" dict and offers what reference.BlockChain offers,
in its block form (halves at L // 2, blocks in the same order): H v in
float64 (`__call__`), `n`, `block`, `from_kron`, `from_flat`,
`sz_q_weights`, `phi_q`; a subclass of BlockChain that replaces the
couplings is the expected shape."""
