"""The protocol circuits and the in-circuit gadget standard library.

Circuits (the recursion chain, reference circuits/ + spec/params curve
assignment):
  1. ballotproof       — BN254   (client-side ballot correctness)
  2. voteverifier      — BLS12-377 (verifies 1 + binds the Ethereum key)
  3. aggregator        — BW6-761 (natively verifies up to 60 of 2)
  4. statetransition   — BN254   (state writes + tally + blob + verifies 3)
  5. results           — BN254   (decryption proofs at finalization)

Gadget std-lib: gadgets (native SMT/TE/poseidon), merkle_gadget
(transitions), emulated (non-native fields), algebra (towers/curves),
pairing_gadget / pairing_gadget6 (in-circuit Groth16 verification),
keccak_gadget, ecdsa_gadget, xfield_hash, blob_gadget; artifacts
(PK/VK cache); toycurve (CI-scale real curve family).
"""
