"""The traffic generators: each reads the parameters of a traffic mix
(traffic/<mix>.json, whose "driver" names it) and runs set-up, the
measured window and the output check of one run."""
