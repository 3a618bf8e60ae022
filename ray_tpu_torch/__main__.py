from ray_tpu_torch.scripts import main

raise SystemExit(main())
