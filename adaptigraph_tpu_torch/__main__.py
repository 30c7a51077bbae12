from adaptigraph_tpu_torch.cli import main

main()
