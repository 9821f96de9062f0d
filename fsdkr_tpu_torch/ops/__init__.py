"""Device arithmetic: limb encoding (`limbs`), the RNS route (`rns`) and
its two hand-written Hopper kernels (`rns_kernels`), the CIOS engine
(`montgomery`, `montgomery_kernels`) and device EC over secp256k1
(`ec_batch`, `ec_kernels`)."""
