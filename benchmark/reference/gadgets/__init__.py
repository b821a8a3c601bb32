"""Each gadget's witness layout, one module a gadget named as the traffic
mixes name it (``"gadget"``): ``shares(args) -> (vars_para, vars_input,
num_inputs)``, the two committed shares of the R1CS assignment."""
